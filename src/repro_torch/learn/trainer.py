"""Rolling-window fine-tunes over tap examples (Morpheus-DFP-style) —
``repro_torch.learn.trainer``, the reference's ``repro.learn.trainer`` on
the port's training path.

The trainer holds a bounded buffer of
:class:`~repro_torch.learn.tap.TrainingExample` rows and advances a
**rolling window**: once at least ``min_window`` examples are buffered (and
``stride`` new ones since the last fire), it trains on the newest
``max_window`` examples — deduplicated by order id, keep-latest, so
re-scored orders and label-log corrections supersede their earlier copies —
and records the fire so the next one waits for another stride of fresh
data.

A fine-tune warm-starts from the incumbent's parameters and runs a few
steps of a local SGD/Adam on :func:`~repro_torch.core.lnn.lnn_loss` over
the *window-local* DDS graph: the window's examples are replayed through a
fresh :class:`~repro_torch.core.dds.IncrementalDDSBuilder`, materialized,
padded to a power-of-two node budget and moved to the trainer's device
with its reverse-slot index (``PaddedGraph.with_rev``: on the card the
gradients of the graph aggregations come from their backward kernels,
which read it).  The gradient is autograd's (``jax.value_and_grad`` in the
reference).  With ``head="hybrid"`` the tuned stage-1/2 parameters are
then frozen and the GBDT head is refit on the host on the window's pre-MLP
embeddings (:func:`~repro_torch.models.hybrid.train_hybrid`), yielding a
:class:`~repro_torch.models.hybrid.HybridModel` candidate.

The served parameters never move: a fine-tune starts from detached clones
of the incumbent's leaves and every optimizer update returns new tensors.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.dds import IncrementalDDSBuilder
from repro_torch.core.graph import pad_graph
from repro_torch.core.hetero import type_code_of
from repro_torch.core.lnn import LNNConfig, lnn_loss, lnn_stage1, lnn_stage2_embed
from repro_torch.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.utils.device import resolve_device

__all__ = ["FineTuneResult", "RollingWindowTrainer", "WindowPolicy",
           "adam", "sgd"]


# ---------------------------------------------------------------- optimizers
def sgd(lr: float = 1e-2, momentum: float = 0.0):
    """Plain (heavy-ball) SGD as an ``(init_fn, update_fn)`` pair —
    ``update_fn(grads, state, params) -> (new_params, new_state)``.
    Functional: the new parameters and state are new tensors, computed
    under ``no_grad``; no leaf is updated in place."""

    def init_fn(params):
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update_fn(grads, state, params):
        vel = tree_map(lambda v, g: momentum * v + g, state, grads)
        new = tree_map(lambda p, v: p - lr * v, params, vel)
        return new, vel

    return init_fn, update_fn


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """Adam as an ``(init_fn, update_fn)`` pair (bias-corrected moments, no
    weight decay and no clipping; functional, as :func:`sgd`).  The step
    count is an int32 tensor and the bias corrections are float32 powers of
    it, as in the reference."""

    def init_fn(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_fn(grads, state, params):
        step = state["step"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g * g, state["nu"], grads)
        step_f = step.to(torch.float32)
        c1 = 1 - torch.pow(b1, step_f)
        c2 = 1 - torch.pow(b2, step_f)
        new = tree_map(lambda p, m, n: p - lr * (m / c1) / (torch.sqrt(n / c2) + eps),
                       params, mu, nu)
        return new, {"step": step, "mu": mu, "nu": nu}

    return init_fn, update_fn


_OPTIMIZERS = {"sgd": sgd, "adam": adam}


# -------------------------------------------------------------------- policy
@dataclass(frozen=True)
class WindowPolicy:
    """Rolling-window advance policy: fire on ``min_window`` buffered +
    ``stride`` fresh, train on the newest ``max_window`` (``dedup`` =
    keep-latest per order id)."""

    min_window: int = 32
    max_window: int = 256
    stride: int = 32
    dedup: bool = True

    def __post_init__(self):
        if self.min_window < 1:
            raise ValueError("min_window must be >= 1")
        if self.max_window < self.min_window:
            raise ValueError("max_window must be >= min_window")
        if not (1 <= self.stride <= self.max_window):
            raise ValueError("stride must be in [1, max_window]")


@dataclass
class FineTuneResult:
    """One fine-tune outcome: the candidate model plus its training trace."""

    params: dict                 # tuned LNN tree (tensors on the trainer's device)
    model: object                # what to register: params, or a HybridModel
    head: str                    # 'mlp' | 'hybrid'
    window: int                  # examples actually trained on (post-dedup)
    steps: int
    losses: list                 # per-step lnn_loss values (python floats)


def _pow2_at_least(n: int, floor: int = 64) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


# ------------------------------------------------- pure fine-tune primitives
# Module-level so the inline path and the dedicated trainer process run the
# EXACT same code — in-process fine-tunes are bit-identical to inline ones
# (same ops at the same shapes on the same device with the same intra-op
# thread count), which the parity tests assert.  On the CPU that holds at
# one intra-op thread only: the plain backward of a gather accumulates in
# a thread-dependent order.  The card's backward kernels sum in a fixed one.
def _materialize_window(cfg: LNNConfig, rows: list, *, entity_history: str,
                        max_history, max_deg: int, device):
    """Window rows ``(snapshot, arrival, entities, features, label)`` →
    ``(dds, graph)``: the window-local DDS graph, padded to pow2 nodes (at
    least 64) and ``max_deg`` slots, on ``device`` with its reverse-slot
    index (receptive cones are window-local by design: the rolling window
    IS the context the fine-tune sees, matching its serving horizon)."""
    b = IncrementalDDSBuilder(
        feat_dim=cfg.feat_dim, entity_history=entity_history,
        max_history=max_history)
    for snap, _arr, entities, features, label in sorted(
            rows, key=lambda r: (r[0], r[1])):
        b.add_order(entities, snap, features, label)
    dds = b.build()
    pg = pad_graph(dds.coo,
                   num_nodes=_pow2_at_least(dds.coo.num_nodes),
                   max_deg=max_deg)
    return dds, pg.to(device).with_rev()


def _fine_tune(params, cfg: LNNConfig, pg, optimizer: str, lr: float,
               steps: int):
    """A few steps of the local optimizer on ``lnn_loss`` over the window
    graph, with autograd on (a caller may hold ``no_grad``); returns
    ``(tuned_params, losses)``.  ``params`` is read, never written: the
    steps start from detached clones of its leaves."""
    init_fn, update_fn = _OPTIMIZERS[optimizer](lr)
    params = tree_map(lambda t: t.detach().clone(), params)
    opt = init_fn(params)
    losses = []
    with torch.enable_grad():
        for _ in range(steps):
            leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
            loss = lnn_loss(tree_unflatten(params, leaves), cfg, pg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)]
            params, opt = update_fn(tree_unflatten(params, grads), opt, params)
            losses.append(float(loss.detach()))
    return params, losses


def _window_rows(blob) -> list:
    """The window npz (features/labels/snapshots/arrivals, entities flat
    with offsets) back to ``(snapshot, arrival, entities, features, label)``
    rows."""
    feats, labels = blob["features"], blob["labels"]
    snaps, arrivals = blob["snapshots"], blob["arrivals"]
    ent_flat, ent_off = blob["ent_flat"], blob["ent_off"]
    return [
        (int(snaps[i]), float(arrivals[i]),
         tuple(int(e) for e in ent_flat[ent_off[i]:ent_off[i + 1]]),
         feats[i], float(labels[i]))
        for i in range(len(labels))
    ]


def _train_child_main(conn, spec: dict) -> None:  # pragma: no cover
    """Entry point of the dedicated fine-tune process (spawn start method).

    The window ships as an ``.npz`` blob (flat entity array + offsets for
    the ragged cone lists) and the warm start as a params checkpoint; the
    tuned candidate travels back the same way — an npz file the parent
    loads and feeds into the ordinary registration/promotion path.  Only
    the loss trace crosses the pipe.  The child computes on the device the
    spec names (raising without a card when that is CUDA) with the
    parent's intra-op thread count; ``spec`` holds only the port's objects
    and plain values, so unpickling it imports neither JAX nor the
    reference."""
    try:
        from repro_torch.core.lnn import lnn_init
        from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint

        torch.set_num_threads(int(spec["threads"]))
        dev = resolve_device(spec["device"])
        cfg = spec["cfg"]
        with np.load(spec["window_path"]) as blob:
            rows = _window_rows(blob)
        template = lnn_init(torch.Generator().manual_seed(0), cfg, device=dev)
        warm = load_checkpoint(spec["warm_path"], template)[0]
        _dds, pg = _materialize_window(
            cfg, rows, entity_history=spec["entity_history"],
            max_history=spec["max_history"], max_deg=spec["max_deg"], device=dev)
        tuned, losses = _fine_tune(
            warm, cfg, pg, spec["optimizer"], spec["lr"], spec["steps"])
        save_checkpoint(spec["out_path"], tuned)
        conn.send(("ok", losses))
    except Exception as e:   # noqa: BLE001 — the parent re-raises
        try:
            conn.send(("error", f"{type(e).__name__}: {e}"))
        except OSError:
            pass
    finally:
        conn.close()


# ------------------------------------------------------------------- trainer
class RollingWindowTrainer:
    """Accumulate tap examples; fine-tune on rolling windows.

    ``k_max``/``max_deg`` come from the serving engine so the window graph
    is padded the same way the batch layer pads — the candidate sees
    exactly the serving geometry.  ``device``: where the fine-tune runs
    (default: CUDA, raising without it; ``"cpu"`` takes the kernels' plain
    versions).
    """

    def __init__(self, cfg: LNNConfig, policy: WindowPolicy | None = None, *,
                 optimizer: str = "adam", lr: float = 5e-3, steps: int = 40,
                 head: str = "mlp", gbdt_trees: int = 25, k_max: int = 8,
                 max_deg: int = 32, entity_history: str = "all",
                 max_history: int | None = None, in_process: bool = False,
                 device=None):
        if optimizer not in _OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {sorted(_OPTIMIZERS)}")
        if head not in ("mlp", "hybrid"):
            raise ValueError("head must be 'mlp' or 'hybrid'")
        if steps < 1:
            raise ValueError("steps must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = policy if policy is not None else WindowPolicy()
        self.optimizer, self.lr, self.steps = optimizer, float(lr), int(steps)
        self.head, self.gbdt_trees = head, int(gbdt_trees)
        self.k_max, self.max_deg = int(k_max), int(max_deg)
        self.entity_history, self.max_history = entity_history, max_history
        # in_process=True runs each fine-tune in a dedicated spawn()ed
        # process (off the serving GIL); the GBDT head refit stays in the
        # parent — the booster isn't an npz-serializable tree
        self.in_process = bool(in_process)
        self._buffer: list = []
        self._since_fire: int | None = None   # None = never fired
        self.stats = {"examples": 0, "fires": 0, "last_window": 0,
                      "last_loss": None}

    # -------------------------------------------------------------- buffering
    def add(self, example) -> None:
        """Buffer one tap example (arrival order)."""
        self._buffer.append(example)
        if self._since_fire is not None:
            self._since_fire += 1
        self.stats["examples"] += 1
        # bound memory: the policy can never look past max_window examples,
        # except that dedup needs slack for superseded duplicates
        cap = 4 * self.policy.max_window
        if len(self._buffer) > cap:
            del self._buffer[: len(self._buffer) - cap]

    def extend(self, examples) -> None:
        """Buffer many tap examples."""
        for ex in examples:
            self.add(ex)

    def ready(self) -> bool:
        """True when the rolling window should advance: enough buffered,
        and a full stride of fresh examples since the last fire."""
        if len(self._buffer) < self.policy.min_window:
            return False
        return self._since_fire is None \
            or self._since_fire >= self.policy.stride

    def _window(self) -> list:
        """The newest ``max_window`` examples, deduped keep-latest."""
        ex = self._buffer
        if self.policy.dedup:
            latest: dict[tuple, object] = {}
            for e in ex:     # later entries overwrite earlier (keep-latest)
                latest[(e.order_id, e.seq if e.order_id < 0 else -1)] = e
            ex = list(latest.values())
        return ex[-self.policy.max_window:]

    # ----------------------------------------------------------------- train
    def train(self, params) -> FineTuneResult:
        """Fine-tune ``params`` on the current window; marks the fire."""
        window = self._window()
        if not window:
            raise ValueError("train() with an empty window")
        self._since_fire = 0
        self.stats["fires"] += 1
        self.stats["last_window"] = len(window)

        if self.in_process:
            params, losses = self._train_in_process(params, window)
            dds = pg = None
        else:
            dds, pg = self._materialize(window)
            params, losses = _fine_tune(
                params, self.cfg, pg, self.optimizer, self.lr, self.steps)
        self.stats["last_loss"] = losses[-1]

        model = params
        if self.head == "hybrid":
            if pg is None:
                # GBDT refit runs in the parent either way; rebuild the
                # (deterministic) window graph the child built for itself
                dds, pg = self._materialize(window)
            model = self._fit_hybrid(params, dds, pg)
            params = model.lnn_params
        return FineTuneResult(params=params, model=model, head=self.head,
                              window=len(window), steps=self.steps,
                              losses=losses)

    def _materialize(self, window):
        """Window examples → window-local DDS graph on the trainer's device
        (see :func:`_materialize_window`)."""
        rows = [(e.snapshot, e.arrival, e.entities, e.features, e.label)
                for e in window]
        return _materialize_window(
            self.cfg, rows, entity_history=self.entity_history,
            max_history=self.max_history, max_deg=self.max_deg,
            device=self.device)

    def _train_in_process(self, params, window):
        """Run one fine-tune in a dedicated spawn()ed process.

        Window examples ship as an npz blob (features/labels/snapshots/
        arrivals + flat entities with offsets), the warm start as a params
        checkpoint; the tuned candidate comes back as an npz the parent
        loads into the warm start's tree structure, on its device.  Nothing
        CUDA crosses the boundary, and the child is spawned, never forked,
        so it inherits no CUDA context; on the card the parent builds (or
        finds) the kernel library first, and the child loads it.  A child
        that dies or reports an error raises — the trainer never silently
        falls back to a stale candidate, nor to the CPU."""
        from multiprocessing import get_context

        from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint

        if self.device.type == "cuda":
            from repro_torch.kernels import _build

            _build.load_library()
        tmp = tempfile.mkdtemp(prefix="repro-torch-finetune-")
        try:
            warm_path = os.path.join(tmp, "warm.npz")
            out_path = os.path.join(tmp, "tuned.npz")
            window_path = os.path.join(tmp, "window.npz")
            save_checkpoint(warm_path, params)
            ent_flat: list[int] = []
            ent_off = [0]
            for e in window:
                ent_flat.extend(int(x) for x in e.entities)
                ent_off.append(len(ent_flat))
            np.savez(
                window_path,
                features=np.stack([np.asarray(e.features, np.float32)
                                   for e in window]),
                labels=np.asarray([e.label for e in window], np.float32),
                snapshots=np.asarray([e.snapshot for e in window], np.int64),
                arrivals=np.asarray([e.arrival for e in window], np.float64),
                ent_flat=np.asarray(ent_flat, np.int64),
                ent_off=np.asarray(ent_off, np.int64))
            spec = {
                # the port's LNNConfig: a reference object would import the
                # reference (and JAX) in the child to unpickle
                "cfg": self.cfg, "window_path": window_path,
                "warm_path": warm_path, "out_path": out_path,
                "optimizer": self.optimizer, "lr": self.lr,
                "steps": self.steps, "max_deg": self.max_deg,
                "entity_history": self.entity_history,
                "max_history": self.max_history,
                "device": str(self.device),
                "threads": torch.get_num_threads(),
            }
            ctx = get_context("spawn")
            parent_conn, child_conn = ctx.Pipe()
            proc = ctx.Process(target=_train_child_main,
                               args=(child_conn, spec),
                               name="repro-torch-finetune", daemon=True)
            proc.start()
            child_conn.close()
            try:
                status, payload = parent_conn.recv()
            except EOFError:
                raise RuntimeError(
                    "fine-tune process died before returning a result") from None
            finally:
                proc.join()
                parent_conn.close()
            if status != "ok":
                raise RuntimeError(f"fine-tune process failed: {payload}")
            tuned = load_checkpoint(out_path, params)[0]
            return tuned, payload
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _fit_hybrid(self, params, dds, pg):
        """Refit the GBDT head on the tuned-then-frozen embedding: stage 1
        over the window graph (``no_grad``), each order's final-hop cone
        gathered on the host into the online [B, K, H] layout, then
        ``train_hybrid`` on the pre-MLP stage-2 embeddings."""
        from repro_torch.baselines.gbdt import GBDTConfig
        from repro_torch.models.hybrid import train_hybrid

        with torch.no_grad():
            h = lnn_stage1(params, self.cfg, pg).float().cpu().numpy()
        n_ord = dds.num_orders
        hid = h.shape[-1]
        ent = np.zeros((n_ord, self.k_max, hid), np.float32)
        mask = np.zeros((n_ord, self.k_max), np.float32)
        slot = np.full((n_ord, self.k_max), -1, np.int32)
        typed = bool(self.cfg.entity_types)
        for o in range(n_ord):
            for k, (e, _t, nid) in enumerate(dds.last_hop.get(o, [])[: self.k_max]):
                ent[o, k] = h[nid]
                mask[o, k] = 1.0
                if typed:
                    slot[o, k] = type_code_of(e)
        dev = self.device
        with torch.no_grad():
            emb = lnn_stage2_embed(
                params, self.cfg, torch.from_numpy(ent).to(dev),
                torch.from_numpy(mask).to(dev), pg.features[:n_ord],
                slot_type=torch.from_numpy(slot).to(dev) if typed else None)
        emb = emb.float().cpu().numpy()
        labels = pg.label[:n_ord].float().cpu().numpy()
        return train_hybrid(params, self.cfg, emb, labels,
                            gbdt_cfg=GBDTConfig(num_trees=self.gbdt_trees),
                            device=dev)

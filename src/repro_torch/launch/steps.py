"""Step builders: train_step / prefill_step / serve_step.

The reference's ``repro.launch.steps``.  Each builder returns ``(fn,
args)``: the step and its abstract arguments (meta tensors, nothing
allocated), as the reference's return a jitted step and
``ShapeDtypeStruct``s.

* On a mesh of more than one device (``launch.mesh.make_production_mesh``)
  the arguments are meta ``DTensor``s with the placements of the sharding
  policy (``dist.sharding``), and ``fn`` runs the port's model code on them
  under ``implicit_replication()`` (tensors the model makes inside are
  replicated) with the layout hints armed, then redistributes its outputs
  to their shardings, as the reference's ``out_shardings``.  Nothing runs
  on any device: the dry-run (``launch.dryrun``) counts what it would do.
* On a mesh of one device (``make_host_mesh``) the arguments are meta
  tensors of that device's shapes and ``fn`` is the port's one-card code:
  called with real tensors on the card (or the CPU) it runs the step, the
  hand-written kernels included.

``make_train_step(cfg)`` without a mesh keeps its one-card form, the bare
step function, which ``launch/train.py`` calls.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.dist.sharding import (P, batch_sharding, cache_sharding, param_sharding,
                                       sharding_hints, spec_placements)
from repro_torch.launch.specs import input_specs
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.models.transformer import decode_step, forward_train, init_params, prefill
from repro_torch.params import tree_map
from repro_torch.train.optim import adamw, cosine_schedule, grad_step
from repro_torch.utils.trace import span


def abstract_params(cfg: ArchConfig):
    """The parameter tree of ``cfg`` on the meta device: the reference's
    ``eval_shape`` of ``init_params`` (nothing is drawn or allocated)."""
    return init_params(torch.Generator(), cfg, device="meta")


def resolve_serve_mode(cfg: ArchConfig, mesh, mode: str) -> str:
    """Resolve 'serve_auto' against the FULL-depth config.  Must happen once,
    up front: the dry-run's 1-layer cost variants would otherwise re-decide
    with a tiny model and silently flip the weight layout."""
    if mode != "serve_auto":
        return mode
    from repro_torch.dist.sharding import _fits_tp_only

    return "serve_tp" if _fits_tp_only(mesh, abstract_params(cfg)) else "serve"


def abstract_opt_state(cfg: ArchConfig, params_spec):
    """AdamW's state of ``params_spec`` on the meta device."""
    init_fn, _ = adamw(1e-4)
    return init_fn(params_spec)


def _opt_sharding(mesh, opt_spec, p_shard):
    """Optimizer moments share the param shardings; step is replicated."""
    return type(opt_spec)(
        step=P(),
        mu=tree_map(lambda x, s: s, opt_spec.mu, p_shard),
        nu=tree_map(lambda x, s: s, opt_spec.nu, p_shard),
    )


# ---------------------------------------------------------------------------
# the mesh boundary: abstract arguments placed, outputs redistributed
# ---------------------------------------------------------------------------

def _sharded(mesh) -> bool:
    return mesh.device_mesh is not None


def _place(mesh, tree, specs):
    """``tree``'s meta tensors as meta ``DTensor``s of the same global shapes,
    placed by ``specs`` (a tree of resolved specs of the same structure);
    other leaves (the cache's ``pos``) unchanged.  On a one-device mesh the
    tree itself."""
    if not _sharded(mesh):
        return tree
    from torch.distributed.tensor import DTensor, Shard

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        placements = spec_placements(mesh, spec)
        local = list(leaf.shape)
        for axis, pl in zip(mesh.axis_names, placements):
            if isinstance(pl, Shard):
                local[pl.dim] //= mesh.shape[axis]
        shard = torch.empty(local, dtype=leaf.dtype, device="meta")
        return DTensor.from_local(shard, mesh.device_mesh, placements, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return tree_map(one, tree, specs)


def _redistribute(mesh, tree, specs):
    """Every ``DTensor`` leaf of ``tree`` redistributed to its spec in
    ``specs`` (the step's output shardings)."""
    from torch.distributed.tensor import DTensor

    def one(leaf, spec):
        if not isinstance(leaf, DTensor):
            return leaf
        return leaf.redistribute(mesh.device_mesh, spec_placements(mesh, spec))

    return tree_map(one, tree, specs)


def _on_mesh(mesh, body, out_specs, batch_axes=None):
    """``body`` as the step on ``mesh``: the hints armed for the call and, on
    a sharded mesh, run under ``implicit_replication()`` with the outputs
    redistributed to ``out_specs(outputs)``."""

    def step(*args):
        with sharding_hints(mesh, batch_axes), _replicating(mesh):
            out = body(*args)
            if _sharded(mesh):
                out = _redistribute(mesh, out, out_specs(out))
        return out

    return step


def _replicating(mesh):
    if not _sharded(mesh):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, mesh=None, shape: InputShape | None = None, *,
                    use_remat: bool = True, lr: float = 3e-4):
    """``train_step(params, opt_state, batch) -> (params, opt_state, {loss,
    grad_norm, lr})``: the loss of :func:`forward_train` and its gradient
    with respect to every leaf by autograd (``jax.value_and_grad`` in the
    reference; ``train.optim.grad_step``), then AdamW with the reference's
    settings: ``cosine_schedule(lr, 10_000, 500)``, weight decay 0.1 on
    leaves of two or more dimensions, gradients clipped to a global norm of
    1.  The outputs stay on the parameters' device (the loss detached); the
    inputs are not changed.  The optimizer state is ``adamw(...)``'s
    ``init_fn`` of the parameters (any learning rate: it holds only
    zeros).

    Without ``mesh`` the step function itself (the one-card form); with a
    ``mesh`` and ``shape``, ``(fn, (params, opt_state, batch))`` as the
    reference's: FSDP+TP parameters and moments, the batch over the data
    axes, the outputs in the inputs' layout (donated: params and moments)."""
    _, update_fn = adamw(cosine_schedule(lr, 10_000, 500), weight_decay=0.1)

    def train_step(params, opt_state, batch):
        aux = {}

        def update(grads, state, p):
            out = update_fn(grads, state, p)
            aux.update(out[2])
            return out

        with span("train_step"):
            params, opt_state, loss = grad_step(
                lambda p: forward_train(p, cfg, batch, use_remat=use_remat),
                params, opt_state, update)
        return params, opt_state, {"loss": loss, **aux}

    if mesh is None:
        return train_step
    p_spec = abstract_params(cfg)
    o_spec = abstract_opt_state(cfg, p_spec)
    specs = input_specs(cfg, shape)
    with sharding_hints(mesh):
        p_shard = param_sharding(mesh, p_spec, mode="train")
        o_shard = _opt_sharding(mesh, o_spec, p_shard)
        b_shard = batch_sharding(mesh, specs["batch"])
    scalars = {"loss": P(), "grad_norm": P(), "lr": P()}
    fn = _on_mesh(mesh, train_step, lambda out: (p_shard, o_shard, scalars))
    fn.donated = (0, 1)
    args = (_place(mesh, p_spec, p_shard), _place(mesh, o_spec, o_shard),
            _place(mesh, specs["batch"], b_shard))
    return fn, args


def make_prefill_step(cfg: ArchConfig, mesh, shape: InputShape, *, mode: str = "serve"):
    """``prefill_step(params, batch) -> (last logits, cache)``: the prompt
    of ``shape.seq_len`` tokens into a cache of that capacity."""

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        return prefill(params, cfg, tokens, shape.seq_len, extra)

    p_spec = abstract_params(cfg)
    specs = input_specs(cfg, shape)
    with sharding_hints(mesh):
        p_shard = param_sharding(mesh, p_spec, mode=mode)
        b_shard = batch_sharding(mesh, specs["batch"])

    def out_specs(out):
        with sharding_hints(mesh):
            return batch_sharding(mesh, out[0]), cache_sharding(mesh, out[1])

    fn = _on_mesh(mesh, prefill_step, out_specs)
    fn.donated = ()
    return fn, (_place(mesh, p_spec, p_shard), _place(mesh, specs["batch"], b_shard))


def make_serve_step(cfg: ArchConfig, mesh, shape: InputShape, *, mode: str = "serve"):
    """mode 'serve_ws': weight-stationary decode — weights keep the train
    (data, model) layout and are never gathered; the decode BATCH shards
    over the model axis instead, so every d-contraction partial-sums
    single-token activations (KBs) rather than all-gathering weights (GBs).
    Requires global_batch %% model_axis == 0.

    ``serve_step(params, token, cache) -> (logits, cache)``, the cache of
    ``shape.seq_len`` slots (donated, and updated in place)."""
    ws = mode == "serve_ws" and shape.global_batch % mesh.shape["model"] == 0
    batch_axes = ("model",) if ws else None
    if mode == "serve_ws":
        mode = "train"   # weights stay in the FSDP+TP train layout, ungathered

    @torch.no_grad()
    def serve_step(params, token, cache):
        return decode_step(params, cfg, token, cache)

    p_spec = abstract_params(cfg)
    specs = input_specs(cfg, shape)
    with sharding_hints(mesh, batch_axes):
        p_shard = param_sharding(mesh, p_spec, mode=mode)
        t_shard = batch_sharding(mesh, specs["token"])
        c_shard = cache_sharding(mesh, specs["cache"])

    def out_specs(out):
        with sharding_hints(mesh, batch_axes):
            return batch_sharding(mesh, out[0]), c_shard

    fn = _on_mesh(mesh, serve_step, out_specs, batch_axes)
    fn.donated = (2,)
    return fn, (_place(mesh, p_spec, p_shard), _place(mesh, specs["token"], t_shard),
                _place(mesh, specs["cache"], c_shard))


def make_step(cfg: ArchConfig, mesh, shape: InputShape, **kw):
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape, **kw)
    return make_serve_step(cfg, mesh, shape, **kw)

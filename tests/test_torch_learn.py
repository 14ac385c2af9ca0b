"""The port's continuous-learning plane (``repro_torch.learn``) on the CPU,
held against the reference's ``repro.learn`` on the same inputs:

* the WAL training tap: the reference's cases against the port, and the
  port's examples equal to the reference's field for field when both read
  the same log (cones, the delayed-label join, pins under compaction,
  ``include_ingest`` off);
* ``drifting_attack_stream``: the same events, patterns and split;
* the local optimizers within 1e-6 of the reference's on the same
  gradients, and the reference's quadratic descent;
* the rolling-window trainer: the reference's cases; ``_materialize_window``
  equal to the reference's padded graph; ``_fine_tune`` (3 steps, f32)
  within 1e-5 relative on the losses and 1e-4 of each leaf's scale on the
  tuned leaves; ``_fit_hybrid``'s embeddings within 1e-5, and equal trees
  when fitted on the reference's embeddings; ``in_process=True`` equal to
  the inline fine-tune bit for bit (at one intra-op thread and at four),
  its child loading neither JAX nor the reference; the served parameters
  untouched by a fine-tune.

Promotion and the closed loop are in ``tests/test_torch_learn_promotion.py``,
the gateway's learn endpoints in ``tests/test_torch_gateway.py``.
"""
import dataclasses
import multiprocessing

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
import repro.learn as RL
import repro.learn.trainer as RT
import repro.stream.checkpoint as RC
import repro.stream.events as RE
from repro.data.attacks import AttackConfig as RefAttackConfig
from repro_torch.core import LNNConfig, lnn_init
from repro_torch.core.hetero import ENTITY_TYPE_NAMES
from repro_torch.data import AttackConfig, SynthConfig, generate_event_stream
from repro_torch.learn import (LabelLog, RollingWindowTrainer, TrainingExample,
                               WalTrainingTap, WindowPolicy, adam, drifting_attack_stream,
                               recall_at_budget, sgd)
from repro_torch.learn import trainer as PT
from repro_torch.models.hybrid import HybridModel
from repro_torch.params import from_numpy, to_numpy, tree_leaves
from repro_torch.stream.checkpoint import WriteAheadLog
from repro_torch.stream.events import CheckoutEvent

LOSS_RTOL = 1e-5     # fine-tune losses, f32 on both sides
LEAF_TOL = 1e-4      # tuned leaves, of each leaf's scale
EMBED_TOL = 1e-5     # the hybrid refit's stage-2 embeddings
OPT_TOL = 1e-6       # one optimizer update on the same gradients


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small products, and under several test
    workers torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(ref_cfg):
    return LNNConfig(**{f.name: getattr(ref_cfg, f.name)
                        for f in dataclasses.fields(LNNConfig)})


def _to_port(params):
    return from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _ev(i, snapshot=0, entities=(1, 2), label=0.0, feats=None):
    f = np.asarray([0.5, -0.25] if feats is None else feats, np.float32)
    return CheckoutEvent(order_id=i, snapshot=snapshot, entities=tuple(entities),
                         features=f, label=float(label), arrival=0.01 * i)


# ------------------------------------------------------------------ WAL tap
def test_tap_emits_examples_with_strictly_past_cones(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    wal.append_event("submit", _ev(0, snapshot=0, entities=(7, 8)))
    wal.append_event("submit", _ev(1, snapshot=1, entities=(7, 9)))
    wal.append_model(1, "models/v1.npz")     # non-event records are skipped
    wal.append_event("ingest", _ev(2, snapshot=2, entities=(8, 9)))
    with WalTrainingTap(wal, feat_dim=2) as tap:
        out = tap.poll()
        assert [ex.order_id for ex in out] == [0, 1, 2]
        assert [ex.seq for ex in out] == [1, 2, 4]
        assert out[0].entity_keys == ()
        assert out[1].entity_keys == ((7, 0),)
        assert out[2].entity_keys == ((8, 0), (9, 1))
        assert all(t < ex.snapshot for ex in out for (_e, t) in ex.entity_keys)
        assert tap.cursor == wal.last_seq
        assert tap.stats["skipped"] == 1
        assert tap.poll() == []
    wal.close()


def test_tap_include_ingest_off(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    wal.append_event("submit", _ev(0))
    wal.append_event("ingest", _ev(1))
    with WalTrainingTap(wal, feat_dim=2, include_ingest=False) as tap:
        assert [ex.order_id for ex in tap.poll()] == [0]
        assert tap.stats["skipped"] == 1
    wal.close()


def test_label_log_join_overrides_event_label(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    for i in range(3):
        wal.append_event("submit", _ev(i, label=0.0))
    log = LabelLog()
    with WalTrainingTap(wal, feat_dim=2, label_log=log, label_latency_s=10.0) as tap:
        assert tap.poll(now=0.1) == []
        assert tap.pending == 3
        log.record(1, 1.0)
        out = tap.poll(now=0.1)
        assert [ex.order_id for ex in out] == [1]
        assert out[0].label == 1.0 and out[0].label_source == "label_log"
        out = tap.poll(now=100.0)
        assert sorted(ex.order_id for ex in out) == [0, 2]
        assert all(ex.label == 0.0 and ex.label_source == "event" for ex in out)
        assert tap.stats["label_joins"] == 1
        assert tap.stats["label_defaults"] == 2
        assert tap.pending == 0
    wal.close()


def test_tap_rejects_negative_latency(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    with pytest.raises(ValueError, match="label_latency_s"):
        WalTrainingTap(wal, feat_dim=2, label_latency_s=-1.0)
    wal.close()


def test_tap_pins_survive_interleaved_compaction(tmp_path):
    """Every submit record is emitted exactly once while compaction runs
    behind the tap's cursor; the pin clamps it, and close releases it."""
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    with WalTrainingTap(wal, feat_dim=2) as tap:
        seen = []
        for i in range(12):
            wal.append_event("submit", _ev(i))
            if i % 3 == 2:
                wal.compact(wal.last_seq)
                seen += [ex.order_id for ex in tap.poll()]
        seen += [ex.order_id for ex in tap.poll()]
        assert seen == list(range(12))
        assert wal.min_pinned() == tap.cursor
    assert wal.min_pinned() is None
    wal.close()


# ------------------------------------------- tap: port == reference, same log
@pytest.fixture(scope="module")
def stream():
    events, g, _ = generate_event_stream(
        SynthConfig(num_users=30, num_rings=2, feature_noise=0.8, seed=5), rate_per_s=500.0)
    return events[:60], g.order_features.shape[1]


_TAP_PKGS = {
    "port": dict(wal=WriteAheadLog, tap=WalTrainingTap, log=LabelLog, event=CheckoutEvent),
    "ref": dict(wal=RC.WriteAheadLog, tap=RL.WalTrainingTap, log=RL.LabelLog,
                event=RE.CheckoutEvent),
}


def _tap_scenario(pkg: str, case: str, events, feat_dim, root) -> tuple:
    """One tap scenario through one package's WAL and tap, from the same
    events: every example's fields, in emission order, and the stats."""
    ns = _TAP_PKGS[pkg]
    events = [ns["event"](**{f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)})
              for ev in events]
    wal = ns["wal"](str(root / "wal.jsonl"))
    log = ns["log"]()
    kw = {"label_join": dict(label_log=log, label_latency_s=0.02),
          "no_ingest": dict(include_ingest=False)}.get(case, {})
    out = []
    with ns["tap"](wal, feat_dim, **kw) as tap:
        for i, ev in enumerate(events):
            wal.append_event("ingest" if i % 4 == 3 else "submit", ev)
            if i == 20:
                wal.append_model(1, "models/v1.npz")
            if case == "label_join" and i % 5 == 0:
                log.record(ev.order_id, 1.0 - ev.label)
            if i % 7 == 6:
                if case == "compaction":
                    wal.compact(wal.last_seq)
                out += tap.poll(now=ev.arrival if case == "label_join" else None)
        out += tap.poll(now=1e9 if case == "label_join" else None)
        stats = dict(tap.stats, cursor=tap.cursor, pending=tap.pending)
    wal.close()
    return [(ex.order_id, ex.snapshot, ex.entities, ex.features.tobytes(), ex.label,
             ex.arrival, ex.seq, ex.entity_keys, ex.label_source) for ex in out], stats


@pytest.mark.parametrize("case", ["cones", "label_join", "compaction", "no_ingest"])
def test_tap_examples_equal_reference(stream, case, tmp_path):
    events, feat_dim = stream
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    port = _tap_scenario("port", case, events, feat_dim, tmp_path / "p")
    ref = _tap_scenario("ref", case, events, feat_dim, tmp_path / "r")
    assert port == ref
    examples, stats = port
    assert examples and stats["pending"] == 0
    if case == "label_join":
        assert stats["label_joins"] > 0 and stats["label_defaults"] > 0
    # both packages' logs are the same bytes
    assert (tmp_path / "p" / "wal.jsonl").read_bytes() == \
        (tmp_path / "r" / "wal.jsonl").read_bytes()


def test_tap_reads_a_log_the_reference_wrote(stream, tmp_path):
    events, feat_dim = stream
    root = tmp_path / "r"
    root.mkdir()
    want, _ = _tap_scenario("ref", "cones", events, feat_dim, root)
    wal = WriteAheadLog(str(root / "wal.jsonl"))
    with WalTrainingTap(wal, feat_dim) as tap:
        got = [(ex.order_id, ex.snapshot, ex.entities, ex.features.tobytes(), ex.label,
                ex.arrival, ex.seq, ex.entity_keys, ex.label_source) for ex in tap.poll()]
    wal.close()
    assert got == want


# ------------------------------------------------------------------ drift
@pytest.mark.parametrize("kw", [
    dict(num_buyers=60, num_rings=3, ring_size=5, num_snapshots=10, num_bursts=1,
         num_bin_runs=1, seed=0),
    dict(num_buyers=40, num_rings=2, ring_size=4, num_snapshots=6, num_bursts=1,
         num_bin_runs=1, seed=3),
], ids=["closed-loop", "seed3"])
def test_drifting_stream_equals_reference(kw):
    events, patterns, split = drifting_attack_stream(AttackConfig(**kw), rate_per_s=500.0)
    ref_events, ref_patterns, ref_split = RL.drifting_attack_stream(
        RefAttackConfig(**kw), rate_per_s=500.0)
    assert split == ref_split and 0 < split < len(events)
    assert list(patterns) == list(ref_patterns)
    assert len(events) == len(ref_events)
    for ev, rv in zip(events, ref_events):
        assert (ev.order_id, ev.snapshot, ev.entities, ev.label, ev.arrival) == \
            (rv.order_id, rv.snapshot, rv.entities, rv.label, rv.arrival)
        assert ev.features.dtype == rv.features.dtype
        assert ev.features.tobytes() == rv.features.tobytes()


# ----------------------------------------------------------- window + optim
def test_window_policy_validation():
    with pytest.raises(ValueError, match="min_window"):
        WindowPolicy(min_window=0)
    with pytest.raises(ValueError, match="max_window"):
        WindowPolicy(min_window=8, max_window=4)
    with pytest.raises(ValueError, match="stride"):
        WindowPolicy(stride=0)
    with pytest.raises(ValueError, match="stride"):
        WindowPolicy(max_window=64, stride=65)


@pytest.mark.parametrize("make", [sgd, adam])
def test_local_optimizers_descend_quadratic(make):
    """Both local optimizers minimize 0.5*||w||^2 (grad = w)."""
    init_fn, update_fn = make(0.1)
    params = {"w": torch.tensor([4.0, -3.0])}
    state = init_fn(params)
    norms = [float(params["w"].norm())]
    for _ in range(50):
        params, state = update_fn({"w": params["w"]}, state, params)
        norms.append(float(params["w"].norm()))
    assert norms[-1] < 0.25 * norms[0]
    assert all(b <= a + 1e-6 for a, b in zip(norms, norms[1:]))


@pytest.mark.parametrize("name,kw", [("sgd", dict(lr=0.05)), ("sgd", dict(lr=0.05, momentum=0.9)),
                                     ("adam", dict(lr=1e-2)), ("adam", dict(lr=3e-3, b2=0.99))],
                         ids=["sgd", "sgd-momentum", "adam", "adam-b2"])
def test_optimizers_match_reference(name, kw):
    """Five updates on the same gradients (drawn from a seed, one per step)
    over a small tree: the port's parameters within 1e-6 of the
    reference's, and the inputs never written."""
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.normal(0, 1, (5, 3)).astype(np.float32)},
            "b": [rng.normal(0, 1, 4).astype(np.float32), np.float32(rng.normal())]}
    grads = [jax.tree_util.tree_map(
        lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32), tree) for _ in range(5)]
    r_init, r_update = getattr(RL, name)(**kw)
    p_init, p_update = {"sgd": sgd, "adam": adam}[name](**kw)
    rp, rs = tree, r_init(tree)
    pp = from_numpy(tree, "cpu")
    before = [t.clone() for t in tree_leaves(pp)]
    first = pp
    ps = p_init(pp)
    for g in grads:
        rp, rs = r_update(g, rs, rp)
        pp, ps = p_update(from_numpy(g, "cpu"), ps, pp)
    for got, want in zip(tree_leaves(to_numpy(pp)), jax.tree_util.tree_leaves(rp)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=OPT_TOL)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(first)))


def test_trainer_rejects_bad_knobs():
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=4, feat_dim=2)
    with pytest.raises(ValueError, match="optimizer"):
        RollingWindowTrainer(cfg, optimizer="lbfgs", device="cpu")
    with pytest.raises(ValueError, match="head"):
        RollingWindowTrainer(cfg, head="transformer", device="cpu")
    with pytest.raises(ValueError, match="steps"):
        RollingWindowTrainer(cfg, steps=0, device="cpu")


def _tap_ex(i, *, order_id=None, seq=None, label=0.0, snapshot=0, cls=TrainingExample):
    rng = np.random.default_rng(i)
    return cls(order_id=i if order_id is None else order_id, snapshot=snapshot,
               entities=(100 + i % 5, 200 + i % 3),
               features=rng.normal(0, 1, 6).astype(np.float32),
               label=label, arrival=0.01 * i, seq=i + 1 if seq is None else seq)


def test_trainer_ready_follows_stride():
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=4, feat_dim=6)
    tr = RollingWindowTrainer(cfg, WindowPolicy(min_window=4, max_window=8, stride=3),
                              steps=1, device="cpu")
    for i in range(3):
        tr.add(_tap_ex(i))
    assert not tr.ready()
    tr.add(_tap_ex(3))
    assert tr.ready()
    tr.train(lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    assert not tr.ready()
    tr.extend(_tap_ex(i) for i in range(4, 6))
    assert not tr.ready()
    tr.add(_tap_ex(6))
    assert tr.ready()


def test_trainer_window_dedup_keeps_latest():
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=4, feat_dim=6)
    tr = RollingWindowTrainer(cfg, WindowPolicy(min_window=1, max_window=8, stride=1),
                              device="cpu")
    tr.add(_tap_ex(0, order_id=42, seq=1, label=0.0))
    tr.add(_tap_ex(1, order_id=7, seq=2))
    tr.add(_tap_ex(2, order_id=42, seq=3, label=1.0))
    window = tr._window()
    assert len(window) == 2
    by_id = {e.order_id: e for e in window}
    assert by_id[42].label == 1.0 and by_id[42].seq == 3
    tr2 = RollingWindowTrainer(cfg, WindowPolicy(min_window=1, max_window=8, stride=1),
                               device="cpu")
    tr2.add(_tap_ex(0, order_id=-1, seq=1))
    tr2.add(_tap_ex(1, order_id=-1, seq=2))
    assert len(tr2._window()) == 2


def test_trainer_finetunes_and_fits_hybrid_head():
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=4, feat_dim=6, mlp_dims=(4,))
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    served = [t.clone() for t in tree_leaves(params)]
    examples = [_tap_ex(i, label=float(i % 2), snapshot=i // 4) for i in range(12)]
    tr = RollingWindowTrainer(cfg, WindowPolicy(min_window=8, max_window=16, stride=8),
                              optimizer="adam", lr=5e-2, steps=6, head="mlp", device="cpu")
    tr.extend(examples)
    res = tr.train(params)
    assert res.window == 12 and len(res.losses) == 6
    assert all(np.isfinite(l) for l in res.losses)
    assert res.losses[-1] < res.losses[0]
    assert res.model is res.params
    assert not any(t.requires_grad for t in tree_leaves(res.params))
    # the served leaves never moved
    assert all(torch.equal(a, b) for a, b in zip(served, tree_leaves(params)))

    hy = RollingWindowTrainer(cfg, WindowPolicy(min_window=8, max_window=16, stride=8),
                              steps=2, head="hybrid", gbdt_trees=5, k_max=4, device="cpu")
    hy.extend(examples)
    hres = hy.train(params)
    assert isinstance(hres.model, HybridModel)
    assert hres.model.lnn_params is hres.params
    with pytest.raises(ValueError, match="empty window"):
        RollingWindowTrainer(cfg, device="cpu").train(params)


def test_fine_tune_turns_autograd_on_under_no_grad():
    """A flush holds ``no_grad``; a fine-tune called from inside one still
    descends."""
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=4, feat_dim=6, mlp_dims=(4,))
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tr = RollingWindowTrainer(cfg, WindowPolicy(min_window=8, max_window=16, stride=8),
                              lr=5e-2, steps=4, device="cpu")
    tr.extend(_tap_ex(i, label=float(i % 2), snapshot=i // 4) for i in range(12))
    with torch.no_grad():
        res = tr.train(params)
    assert res.losses[-1] < res.losses[0]


def test_recall_at_budget_skips_nan_labels():
    labels = [1.0, 0.0, float("nan"), 1.0, 0.0, 0.0]
    scores = [0.9, 0.1, 0.99, 0.8, 0.2, 0.3]
    assert recall_at_budget(labels, scores, 0.5) == 1.0
    assert np.isnan(recall_at_budget([0.0, 0.0], [0.5, 0.5], 0.5))
    assert np.isnan(recall_at_budget([], [], 0.5))
    rng = np.random.default_rng(1)
    lab = (rng.random(200) > 0.8).astype(np.float64)
    lab[rng.integers(0, 200, 10)] = np.nan
    sc = np.round(rng.random(200), 2)        # ties, broken stably by both
    for budget in (0.05, 0.15, 0.5):
        assert recall_at_budget(lab, sc, budget) == RL.recall_at_budget(lab, sc, budget)


# ----------------------------------------- the fine-tune against the reference
@pytest.fixture(scope="module")
def window_world():
    """A window of tap-shaped rows from the synthetic stream (typed and
    untyped configs share it), the reference's parameters per GNN type and
    the port's copies."""
    events, g, _ = RD.generate_event_stream(
        RD.SynthConfig(num_users=40, num_rings=2, feature_noise=0.8, seed=11),
        rate_per_s=500.0)
    rows = [(ev.snapshot, ev.arrival, tuple(ev.entities), np.asarray(ev.features, np.float32),
             float(ev.label)) for ev in events[:96]]
    return rows, g.order_features.shape[1]


def _ref_world(window_world, gnn, typed=False):
    rows, feat_dim = window_world
    ref_cfg = R.LNNConfig(gnn_type=gnn, num_gnn_layers=3, hidden_dim=16, mlp_dims=(16, 8),
                          feat_dim=feat_dim,
                          entity_types=ENTITY_TYPE_NAMES if typed else ())
    params = R.lnn_init(jax.random.PRNGKey(3), ref_cfg)
    return rows, ref_cfg, params


_MAT = dict(entity_history="all", max_history=None, max_deg=8)


def test_materialize_window_equals_reference(window_world):
    rows, ref_cfg, _ = _ref_world(window_world, "gcn")
    rdds, rpg = RT._materialize_window(ref_cfg, rows, **_MAT)
    dds, pg = PT._materialize_window(_port_cfg(ref_cfg), rows, device="cpu", **_MAT)
    assert pg.num_nodes == rpg.num_nodes and pg.num_nodes >= 64
    assert pg.num_nodes & (pg.num_nodes - 1) == 0
    for name in rpg._fields:
        want = getattr(rpg, name)
        got = getattr(pg, name)
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert pg.rev is not None                     # the backward kernels' index
    assert dds.num_orders == rdds.num_orders and dds.last_hop == rdds.last_hop


def _leaf_gap(got, want) -> float:
    """Worst max|Δ| over the leaves, each over its own scale."""
    worst = 0.0
    for g, w in zip(tree_leaves(to_numpy(got)), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w, np.float64)
        worst = max(worst, float(np.abs(np.asarray(g, np.float64) - w).max())
                    / max(float(np.abs(w).max()), 1e-12))
    return worst


#: GAT leaves whose gradient is zero in exact arithmetic: the last layer's
#: neighbour softmax runs over an order's final-hop slots only, which all
#: share one destination and one edge type, so its ``a_dst`` term and its
#: edge-type bias add one value to every logit of the row, and a softmax
#: does not change when every logit of a row moves alike.  In f32 their
#: gradients are rounding noise, which Adam divides by its own scale and
#: turns into steps of up to ~lr either way, on each side independently;
#: ``last/a_et`` also starts at zero, so it has no scale to be held to.
_ZERO_GRAD_GAT = ("last/a_dst", "last/a_et")


def _grads(ref_params, ref_cfg, rpg, warm, cfg, pg):
    """``lnn_loss``'s gradients at the warm start, per key path, from both
    packages."""
    from repro_torch.core import lnn_loss
    from repro_torch.params import flatten_paths, tree_unflatten

    ref = jax.grad(lambda p: R.lnn_loss(p, ref_cfg, rpg))(ref_params)
    ref = dict(flatten_paths(jax.tree_util.tree_map(np.asarray, ref)))
    leaves = [t.detach().requires_grad_() for t in tree_leaves(warm)]
    grads = torch.autograd.grad(lnn_loss(tree_unflatten(warm, leaves), cfg, pg), leaves,
                                allow_unused=True)
    port = {k: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
            for (k, t), g in zip(flatten_paths(warm), grads)}
    return ref, port


@pytest.mark.parametrize("gnn,optimizer", [("gcn", "adam"), ("gat", "adam"), ("sage", "adam"),
                                           ("gcn", "sgd"), ("gat", "sgd")])
def test_fine_tune_matches_reference(window_world, gnn, optimizer):
    """Three steps at lr 1e-2 from the same warm start: losses within 1e-5
    relative, every tuned leaf within 1e-4 of its scale.  GAT's leaves in
    ``_ZERO_GRAD_GAT`` start at zero scale or move by noise alone, so
    instead their gradients must be rounding noise on both sides (≤ 1e-6
    of the largest gradient), and their steps are held to the optimizer's
    bound for such a gradient: Adam's largest step, lr (1 - b1) /
    sqrt(1 - b2) ≈ 3.2 lr, and SGD's lr times the noise."""
    from repro_torch.params import flatten_paths

    rows, ref_cfg, ref_params = _ref_world(window_world, gnn)
    cfg = _port_cfg(ref_cfg)
    lr, steps = 1e-2, 3
    _, rpg = RT._materialize_window(ref_cfg, rows, **_MAT)
    ref_tuned, ref_losses = RT._fine_tune(ref_params, ref_cfg, rpg, optimizer, lr, steps)
    _, pg = PT._materialize_window(cfg, rows, device="cpu", **_MAT)
    warm = _to_port(ref_params)
    tuned, losses = PT._fine_tune(warm, cfg, pg, optimizer, lr, steps)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL, atol=0)
    noise = _ZERO_GRAD_GAT if gnn == "gat" else ()
    if noise:
        ref_g, port_g = _grads(ref_params, ref_cfg, rpg, warm, cfg, pg)
        top = max(float(np.abs(g).max()) for g in ref_g.values())
        for key in noise:
            assert float(np.abs(ref_g[key]).max()) <= 1e-6 * top, key
            assert float(np.abs(port_g[key]).max()) <= 1e-6 * top, key
    step_bound = {"adam": 3.2 * lr, "sgd": lr * 1e-6 * top if noise else 0.0}[optimizer]
    want = dict(flatten_paths(jax.tree_util.tree_map(np.asarray, ref_tuned)))
    for key, got in flatten_paths(to_numpy(tuned)):
        gap = float(np.abs(got.astype(np.float64) - want[key]).max())
        if key in noise:
            assert gap <= 2 * steps * step_bound, (key, gap)
        else:
            assert gap <= LEAF_TOL * float(np.abs(want[key]).max()), (key, gap)
    assert _leaf_gap(warm, ref_params) == 0.0     # the warm start was not written


def test_fit_hybrid_matches_reference(window_world, monkeypatch):
    """The refit on the same tuned parameters: the stage-2 embeddings the
    booster is fitted on within 1e-5 of the reference's, and the port's
    booster fitted on the reference's embeddings equal to the reference's,
    tree for tree."""
    import repro.models.hybrid as RH

    import repro_torch.models.hybrid as PH

    rows, ref_cfg, ref_params = _ref_world(window_world, "gat", typed=True)
    cfg = _port_cfg(ref_cfg)
    seen = {}

    def capture(name, real):
        def fit(params, cfg, emb, labels, **kw):
            seen[name] = (np.asarray(emb), np.asarray(labels))
            return real(params, cfg, emb, labels, **kw)
        return fit

    monkeypatch.setattr(RH, "train_hybrid", capture("ref", RH.train_hybrid))
    monkeypatch.setattr(PH, "train_hybrid", capture("port", PH.train_hybrid))
    examples = [TrainingExample(order_id=i, snapshot=r[0], arrival=r[1], entities=r[2],
                                features=r[3], label=r[4], seq=i + 1)
                for i, r in enumerate(rows)]
    ref_tr = RL.RollingWindowTrainer(ref_cfg, RL.WindowPolicy(min_window=8, max_window=128),
                                     steps=2, head="hybrid", gbdt_trees=6, k_max=4, max_deg=8)
    ref_tr.extend([RL.TrainingExample(**dataclasses.asdict(e)) for e in examples])
    ref_res = ref_tr.train(ref_params)
    tr = RollingWindowTrainer(cfg, WindowPolicy(min_window=8, max_window=128), steps=2,
                              head="hybrid", gbdt_trees=6, k_max=4, max_deg=8, device="cpu")
    tr.extend(examples)
    # from the reference's tuned parameters, so the refit alone is compared
    res_model = tr._fit_hybrid(_to_port(ref_res.params), *tr._materialize(tr._window()))
    emb, labels = seen["port"]
    ref_emb, ref_labels = seen["ref"]
    np.testing.assert_array_equal(labels, ref_labels)
    assert float(np.abs(emb - ref_emb).max()) <= EMBED_TOL
    assert isinstance(res_model, HybridModel)
    fitted = PH.train_hybrid(_to_port(ref_res.params), cfg, ref_emb, ref_labels,
                             gbdt_cfg=res_model.gbdt.cfg, device="cpu")
    want = ref_res.model.gbdt
    assert fitted.gbdt.base_score == want.base_score
    assert len(fitted.gbdt.trees) == len(want.trees) == 6
    for t, w in zip(fitted.gbdt.trees, want.trees):
        for f in ("feature", "threshold_bin", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(t, f), getattr(w, f), err_msg=f)
    for e, w in zip(fitted.gbdt.bin_edges, want.bin_edges):
        np.testing.assert_array_equal(e, w)


# --------------------------------------------------- the spawned trainer child
def test_in_process_equals_inline_and_loads_only_the_port(window_world, capfd, monkeypatch):
    """``in_process=True``: the spawned child's losses and tuned leaves equal
    the inline fine-tune's bit for bit (same code, same shapes, same thread
    count), the hybrid refit on top of it too, and the child's import log
    (``PYTHONPROFILEIMPORTTIME``, on the stderr it inherits) names
    ``repro_torch.learn.trainer`` and no module of JAX or the reference."""
    rows, ref_cfg, ref_params = _ref_world(window_world, "sage", typed=True)
    cfg = _port_cfg(ref_cfg)
    params = _to_port(ref_params)
    examples = [TrainingExample(order_id=i, snapshot=r[0], arrival=r[1], entities=r[2],
                                features=r[3], label=r[4], seq=i + 1)
                for i, r in enumerate(rows)]
    results = []
    for in_process in (False, True):
        tr = RollingWindowTrainer(cfg, WindowPolicy(min_window=8, max_window=128), steps=3,
                                  lr=1e-2, head="hybrid", gbdt_trees=4, k_max=4, max_deg=8,
                                  in_process=in_process, device="cpu")
        tr.extend(examples)
        if in_process:
            monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
        results.append(tr.train(params))
    inline, child = results
    assert child.losses == inline.losses
    for a, b in zip(tree_leaves(child.params), tree_leaves(inline.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    probe = np.random.default_rng(0).normal(0, 1, (16, cfg.hidden_dim + cfg.feat_dim))
    assert np.array_equal(child.model.gbdt.predict_proba(probe),
                          inline.model.gbdt.predict_proba(probe))
    mods = {line.rsplit("|", 1)[-1].strip()
            for line in capfd.readouterr().err.splitlines() if line.startswith("import time:")}
    assert {"torch", "repro_torch.learn.trainer"} <= mods
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("gnn", ["gcn", "gat"])
def test_in_process_equals_inline_at_four_threads(window_world, gnn):
    """At four intra-op threads the spawned child (which takes the parent's
    thread count) equals the inline fine-tune bit for bit as well: the
    graph aggregations' CPU gradient sums in a fixed order at any thread
    count (GCN's per-type mean, GAT's edge softmax)."""
    rows, ref_cfg, ref_params = _ref_world(window_world, gnn, typed=True)
    cfg = _port_cfg(ref_cfg)
    params = _to_port(ref_params)
    examples = [TrainingExample(order_id=i, snapshot=r[0], arrival=r[1], entities=r[2],
                                features=r[3], label=r[4], seq=i + 1)
                for i, r in enumerate(rows)]
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        results = []
        for in_process in (False, True):
            tr = RollingWindowTrainer(cfg, WindowPolicy(min_window=8, max_window=128), steps=3,
                                      lr=1e-2, k_max=4, max_deg=8, in_process=in_process,
                                      device="cpu")
            tr.extend(examples)
            results.append(tr.train(params))
    finally:
        torch.set_num_threads(n)
    inline, child = results
    assert child.losses == inline.losses
    for a, b in zip(tree_leaves(child.params), tree_leaves(inline.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not multiprocessing.active_children()


def test_in_process_child_failure_raises(window_world):
    """A child that reports an error raises in the parent; no stale
    candidate comes back."""
    rows, ref_cfg, ref_params = _ref_world(window_world, "gcn")
    cfg = _port_cfg(ref_cfg)
    tr = RollingWindowTrainer(cfg, WindowPolicy(min_window=4, max_window=64), steps=1,
                              max_deg=8, in_process=True, device="cpu")
    tr.extend(TrainingExample(order_id=i, snapshot=r[0], arrival=r[1], entities=r[2],
                              features=r[3][:2], label=r[4], seq=i + 1)   # wrong width
              for i, r in enumerate(rows[:8]))
    with pytest.raises(RuntimeError, match="fine-tune process failed: ValueError"):
        tr.train(_to_port(ref_params))
    assert tr.stats["last_loss"] is None


# --------------------------- the service surface the learn plane stands on
@pytest.fixture(scope="module")
def learn_world():
    events, g, _ = generate_event_stream(
        SynthConfig(num_users=30, num_rings=2, feature_noise=0.8, seed=5), rate_per_s=500.0)
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=8, feat_dim=g.order_features.shape[1],
                    mlp_dims=(8,))
    return events[:24], cfg, lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")


def _build(cfg, params):
    from repro_torch.service import FraudService, ModelSection, ServiceConfig

    sc = ServiceConfig(mode="streaming", model=ModelSection.from_lnn_config(cfg)).replace(
        engine={"num_workers": 1, "max_batch": 4})
    return FraudService(sc, params=params, device="cpu").build()


def test_learn_section_from_dict_roundtrip():
    import repro.service as RSV

    from repro_torch.service import ServiceConfig

    d = {"mode": "streaming", "model": {"num_gnn_layers": 2, "hidden_dim": 4, "feat_dim": 2},
         "learn": {"enabled": True, "min_window": 16, "stride": 8, "head": "hybrid",
                   "promote_margin": 0.05, "train_in_process": True}}
    sc = ServiceConfig.from_dict(d)
    assert sc.learn.enabled and sc.learn.min_window == 16 and sc.learn.head == "hybrid"
    assert ServiceConfig.from_dict(sc.to_dict()).learn == sc.learn
    assert sc.to_json() == RSV.ServiceConfig.from_dict(d).to_json()


def test_auto_checkpoint_lifecycle_rules(learn_world, tmp_path):
    from repro_torch.service import ServiceLifecycleError

    _events, cfg, params = learn_world
    svc = _build(cfg, params)
    with pytest.raises(ServiceLifecycleError, match="requires enable_wal"):
        svc.enable_auto_checkpoint(every_s=1.0)
    svc.enable_wal(str(tmp_path / "wal"))
    with pytest.raises(ServiceLifecycleError, match="every_s and/or"):
        svc.enable_auto_checkpoint()
    with pytest.raises(ValueError, match="every_s"):
        svc.enable_auto_checkpoint(every_s=0.0)
    with pytest.raises(ValueError, match="every_windows"):
        svc.enable_auto_checkpoint(every_windows=0)
    with pytest.raises(ValueError, match="keep_last"):
        svc.enable_auto_checkpoint(every_s=1.0, keep_last=0)
    svc.close()


def test_auto_checkpoint_fires_on_injected_clock(learn_world, tmp_path):
    from repro_torch.stream.checkpoint import list_checkpoints

    events, cfg, params = learn_world
    root = str(tmp_path / "wal")
    svc = _build(cfg, params).enable_wal(root)
    t = {"now": 0.0}
    svc.enable_auto_checkpoint(every_s=10.0, keep_last=2, clock=lambda: t["now"])
    for ev in events[:4]:
        svc.submit(ev)
    assert svc.stats().extra["auto_checkpoint"]["checkpoints"] == 0
    t["now"] = 11.0
    svc.submit(events[4])
    assert svc.stats().extra["auto_checkpoint"]["checkpoints"] == 1
    assert len(list_checkpoints(root)) == 1
    for ev in events[5:9]:
        t["now"] += 11.0
        svc.submit(ev)
    st = svc.stats().extra["auto_checkpoint"]
    assert st["checkpoints"] == 5 and st["pruned"] == 3
    assert len(list_checkpoints(root)) == 2
    svc.close()


def test_rollback_model_restores_last_good(learn_world):
    from repro_torch.service import ServiceLifecycleError

    _events, cfg, params = learn_world
    svc = _build(cfg, params)
    with pytest.raises(ServiceLifecycleError, match="last-good"):
        svc.rollback_model()
    v1 = svc.register_perturbed(0, scale=0.0, version=1)
    svc.activate_model(v1)
    assert svc.last_good_version == 0
    svc.enable_shadow(0, fraction=1.0)
    assert svc.rollback_model("test reason") == 0 and svc.model_version == 0
    assert svc.shadow_stats() == {}
    st = svc.stats()
    assert st.rollbacks == 1 and st.last_good_version is None
    assert svc.last_rollback == {"from": v1, "to": 0, "reason": "test reason"}
    with pytest.raises(ServiceLifecycleError):
        svc.rollback_model()
    svc.close()


def test_register_perturbed_keeps_hybrid_structure(learn_world):
    from repro_torch.baselines.gbdt import GBDTConfig
    from repro_torch.models.hybrid import train_hybrid

    _events, cfg, params = learn_world
    svc = _build(cfg, params)
    rng = np.random.default_rng(0)
    hy = train_hybrid(params, cfg, rng.normal(0, 1, (32, cfg.hidden_dim + cfg.feat_dim)),
                      (rng.random(32) > 0.7).astype(np.float32),
                      gbdt_cfg=GBDTConfig(num_trees=3), device="cpu")
    vp = svc.register_perturbed(svc.register_model(hy), scale=2.0)
    perturbed = svc.model_params(vp)
    assert isinstance(perturbed, HybridModel) and perturbed.gbdt is hy.gbdt
    assert not torch.allclose(tree_leaves(hy.lnn_params)[0], tree_leaves(perturbed.lnn_params)[0])
    svc.close()


def test_learner_requires_a_wal_and_reattaches_after_restore(learn_world, tmp_path):
    """No WAL, no learner; a learner rebuilt on a restored service re-attaches
    to the candidate in flight and its tap resumes at the start of the log."""
    from repro_torch.learn import ContinuousLearner
    from repro_torch.service import FraudService

    events, cfg, params = learn_world
    svc = _build(cfg, params)
    with pytest.raises(RuntimeError, match="enabled WAL"):
        ContinuousLearner(svc)
    root = str(tmp_path / "wal")
    svc.enable_wal(root)
    learner = ContinuousLearner(svc)
    for ev in events[:12]:
        svc.submit(ev)
    out = learner.step(force=True)
    assert out["trained"] is not None and out["state"] == "shadowing"
    svc.checkpoint()
    restored = FraudService.restore(root, device="cpu")
    again = ContinuousLearner(restored)
    assert again.controller.state == "shadowing"
    assert again.controller.candidate_version == out["trained"]["candidate"]
    assert again.step()["examples"] == 12
    learner.close()
    again.close()
    svc.close()
    restored.close()

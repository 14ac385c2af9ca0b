"""The port's plain kernel versions (``repro_torch.kernels.ref``, the CPU path
of every kernel and the yardstick its CUDA kernel is held against on the
card) agree with the reference's Pallas kernels, run in interpret mode on
the same numpy inputs.  Tolerances are the reference tests': 2e-5 in f32
(2e-2 in bf16) for the graph kernels and 1e-5 for stage 2; the summation
order differs between the frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LNNConfig as RefConfig
from repro.core import lnn_init as ref_lnn_init
from repro.core.hetero import ENTITY_TYPE_NAMES
from repro.kernels.csr_spmm import csr_spmm_pallas
from repro.kernels.edge_softmax import edge_softmax_agg_pallas
from repro.kernels.stage2_score import flatten_stage2_params as ref_flatten
from repro.kernels.stage2_score import stage2_score_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.stage2_score import (flatten_stage2_params, pack_stage2_params,
                                              ROWS_PER_BLOCK, stage2_plan, unpack_stage2_pack,
                                              unpack_stage2_params)
from repro_torch.params import from_numpy

RNG = np.random.default_rng(42)
GNN_TYPES = ["gcn", "gat", "sage"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------- csr_spmm
@pytest.mark.parametrize("n,deg,h", [(64, 4, 32), (200, 12, 96), (257, 7, 130), (128, 24, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csr_spmm_ref_matches_pallas(n, deg, h, dtype):
    x = RNG.normal(size=(n, h)).astype(np.float32)
    idx = RNG.integers(0, n, (n, deg)).astype(np.int32)
    w = (RNG.uniform(0, 1, (n, deg)) * (RNG.uniform(size=(n, deg)) < 0.7)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = csr_spmm_pallas(jnp.asarray(x, jdt), jnp.asarray(idx), jnp.asarray(w),
                           interpret=True)
    got = ref.csr_spmm_ref(_t(x).to(tdt), _t(idx), _t(w))
    assert got.dtype == tdt
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------- edge_softmax
@pytest.mark.parametrize("n,deg,h", [(64, 6, 32), (150, 16, 64), (96, 3, 128), (257, 40, 130)])
def test_edge_softmax_ref_matches_pallas(n, deg, h):
    z = RNG.normal(size=(n, h)).astype(np.float32)
    ss, sd = (RNG.normal(size=n).astype(np.float32) for _ in range(2))
    idx = RNG.integers(0, n, (n, deg)).astype(np.int32)
    mask = (RNG.uniform(size=(n, deg)) < 0.6).astype(np.float32)
    mask[::7] = 0.0                       # all-masked rows stay finite (zero)
    bias = (RNG.normal(size=(n, deg)) * 0.1).astype(np.float32)
    want = edge_softmax_agg_pallas(*(jnp.asarray(a) for a in (z, ss, sd, idx, mask, bias)),
                                   interpret=True)
    got = ref.edge_softmax_agg_ref(*(_t(a) for a in (z, ss, sd, idx, mask, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert np.all(got.numpy()[::7] == 0.0)


# ------------------------------------------------------------- stage2_score
def _cfg(gnn_type, **kw):
    kw.setdefault("num_gnn_layers", 3)
    kw.setdefault("hidden_dim", 32)
    kw.setdefault("feat_dim", 8)
    return RefConfig(gnn_type=gnn_type, **kw)


def _inputs(b, k, cfg, all_masked_rows=()):
    mask = (RNG.uniform(size=(b, k)) < 0.7).astype(np.float32)
    for i in all_masked_rows:
        mask[i] = 0.0
    emb = RNG.normal(size=(b, k, cfg.hidden_dim)).astype(np.float32) * mask[:, :, None]
    feats = RNG.normal(size=(b, cfg.feat_dim)).astype(np.float32)
    return emb, mask, feats


def _check_stage2(cfg, seed, emb, mask, feats, slot_type=None):
    params = ref_lnn_init(jax.random.PRNGKey(seed), cfg)
    typed = slot_type is not None
    want = stage2_score_pallas(
        jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(feats),
        ref_flatten(params, cfg.gnn_type), gnn_type=cfg.gnn_type, interpret=True,
        slot_type=None if slot_type is None else jnp.asarray(slot_type), typed=typed)
    tparams = from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    got = ref.stage2_score_ref(_t(emb), _t(mask), _t(feats),
                               flatten_stage2_params(tparams, cfg.gnn_type),
                               cfg.gnn_type, None if slot_type is None else _t(slot_type))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    return got.numpy()


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
@pytest.mark.parametrize("b", [1, 2, 3, 5, 8, 13, 16])
def test_stage2_ref_matches_pallas_across_batch_sizes(gnn_type, b):
    cfg = _cfg(gnn_type)
    _check_stage2(cfg, 1, *_inputs(b, 8, cfg, all_masked_rows=(0,) if b > 2 else ()))


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
def test_stage2_ref_all_rows_masked(gnn_type):
    cfg = _cfg(gnn_type)
    b, k = 4, 8
    out = _check_stage2(cfg, 2, np.zeros((b, k, cfg.hidden_dim), np.float32),
                        np.zeros((b, k), np.float32),
                        RNG.normal(size=(b, cfg.feat_dim)).astype(np.float32))
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
@pytest.mark.parametrize("layers,mlp_dims", [(2, (16,)), (4, (64, 32, 16))])
def test_stage2_ref_alternative_depths(gnn_type, layers, mlp_dims):
    cfg = _cfg(gnn_type, num_gnn_layers=layers, mlp_dims=mlp_dims)
    _check_stage2(cfg, 3, *_inputs(6, 4, cfg, all_masked_rows=(1,)))


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
def test_stage2_ref_typed_slots(gnn_type):
    """Typed variant: every type's tower on the original embedding, -1 slots
    (padding or untyped) pass through."""
    cfg = _cfg(gnn_type, num_gnn_layers=2, hidden_dim=8, mlp_dims=(8,), feat_dim=4,
               entity_types=ENTITY_TYPE_NAMES)
    b, k = 6, 4
    emb, mask, feats = _inputs(b, k, cfg, all_masked_rows=(2,))
    st = RNG.integers(0, len(ENTITY_TYPE_NAMES), (b, k)).astype(np.int32)
    st[mask == 0] = -1
    st[0, 0] = -1
    typed = _check_stage2(cfg, 4, emb, mask, feats, st)
    untyped = _check_stage2(cfg, 4, emb, mask, feats, np.full((b, k), -1, np.int32))
    assert not np.array_equal(typed, untyped)


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
@pytest.mark.parametrize("typed", [False, True])
def test_flatten_matches_reference(gnn_type, typed):
    """One flattening (the kernel ABI) for both frameworks, leaf for leaf."""
    cfg = _cfg(gnn_type, entity_types=ENTITY_TYPE_NAMES if typed else ())
    params = ref_lnn_init(jax.random.PRNGKey(5), cfg)
    want = ref_flatten(params, gnn_type)
    got = flatten_stage2_params(
        from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"), gnn_type)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    named = unpack_stage2_params(got, gnn_type, typed)
    assert len(named["mlp"]) == len(cfg.mlp_dims)
    with pytest.raises(ValueError):
        unpack_stage2_params(got[:-1], gnn_type, typed)


def test_ops_stage2_defaults_typed_slots_to_untyped():
    """Typed params without slot types score every slot as untyped (-1)."""
    cfg = _cfg("gcn", entity_types=ENTITY_TYPE_NAMES)
    params = from_numpy(jax.tree_util.tree_map(
        np.asarray, ref_lnn_init(jax.random.PRNGKey(6), cfg)), "cpu")
    emb, mask, feats = (_t(a) for a in _inputs(3, 4, cfg))
    st = torch.full((3, 4), -1, dtype=torch.int32)
    np.testing.assert_array_equal(
        ops.stage2_score(params, "gcn", emb, mask, feats).numpy(),
        ops.stage2_score(params, "gcn", emb, mask, feats, slot_type=st).numpy())


# ------------------------------------------- stage2_score: the kernel's pack
# The kernel reads pack_stage2_params' buffer, laid out by stage2_plan; both
# are host code, held here.  The configurations are chip_smoke.py's cases.
H100_OPTIN = 232448          # shared memory a block may opt in to on the H100
_WIDE = ((2, ()), (2, (1,)), (2, (32,)), (2, (128, 64, 32)),
         (4, ()), (4, (1,)), (4, (32,)), (4, (128, 64, 32)))
CHIP_CASES = ([(g, ty, 48, 64, 8, 3, (64, 32)) for g in GNN_TYPES for ty in (False, True)]
              + [(g, False, 12, 64, 8, 3, (64, 32)) for g in GNN_TYPES]
              + [(g, False, 12, 64, 8, lay, m) for g in GNN_TYPES for lay, m in _WIDE]
              + [(g, ty, 48, 130, 5, 3, (64, 32)) for g in GNN_TYPES for ty in (False, True)]
              + [(g, True, 48, 256, 8, 3, (64, 32)) for g in GNN_TYPES])


def _port_params(gnn_type, typed, f, h, layers=3, mlp=(64, 32), seed=0):
    from repro_torch.core import LNNConfig, lnn_init
    cfg = LNNConfig(gnn_type=gnn_type, num_gnn_layers=layers, hidden_dim=h, mlp_dims=mlp,
                    feat_dim=f, entity_types=ENTITY_TYPE_NAMES if typed else ())
    return lnn_init(torch.Generator().manual_seed(seed), cfg, device="cpu")


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("layers,mlp,f,h", [(3, (64, 32), 12, 64), (2, (), 5, 33),
                                            (4, (128, 64, 32), 48, 130)])
def test_pack_round_trips_to_flat(gnn_type, typed, layers, mlp, f, h):
    """The pack holds every weight exactly once (and GAT's two score vectors
    derived from them), each segment on 16 bytes, and gives the flattening
    back bit for bit."""
    flat = flatten_stage2_params(_port_params(gnn_type, typed, f, h, layers, mlp), gnn_type)
    pack = pack_stage2_params(flat, gnn_type, typed)
    back = unpack_stage2_pack(pack)
    assert len(back) == len(flat)
    for got, want in zip(back, flat):
        assert got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    offsets = [o for o, _ in pack.vectors.values()] + [s.off for s in pack.segments]
    assert all(o % 4 == 0 for o in offsets) and pack.vec_floats % 4 == 0
    assert all(s.stride % 4 == 0 and s.stride >= s.cols for s in pack.segments)
    assert pack.buffer.numel() == pack.segments[-1].off + pack.segments[-1].rows * \
        pack.segments[-1].stride
    derived = 2 * h if gnn_type == "gat" else 0   # GAT's u_src = W a_src and u_dst = W a_dst
    assert sum(t.numel() for t in flat) + derived == sum(
        n for _, n in pack.vectors.values()) + sum(s.rows * s.cols for s in pack.segments)


def _packed_stage2(pack, emb, mask, feats, st=None):
    """The kernel's data flow over the pack: each product reads the next
    matrix of the buffer, the two merged products ([h | agg] and [g |
    feats]) are formed as the kernel forms them, and GAT scores with
    u = W @ a and projects its attention sum of the raw slots."""
    buf, segs = pack.buffer, iter(pack.segments)

    def mat():
        s = next(segs)
        return buf[s.off:s.off + s.rows * s.stride].view(s.rows, s.stride)[:, :s.cols]

    def vec(name):
        o, n = pack.vectors[name]
        return buf[o:o + n]

    e = emb
    for t in range(pack.n_types):
        e = torch.where((st == t)[..., None], torch.relu(emb @ mat() + vec(f"typed_b[{t}]")), e)
    h = torch.relu(feats @ mat() + vec("b_in") + vec("type_row"))
    for i in range(pack.n_tower):
        h = torch.relu(h @ mat() + vec(f"tower_b[{i}]"))
    if pack.gat:
        logits = torch.nn.functional.leaky_relu(
            e @ vec("u_src") + (h @ vec("u_dst"))[:, None] + vec("a_et")[0], 0.2)
        weight = torch.softmax(torch.where(mask > 0, logits, torch.full_like(logits, -1e9)),
                               -1) * mask
    else:
        weight = mask / mask.sum(-1, keepdim=True).clamp_min(1.0)
    agg = torch.einsum("bkh,bk->bh", e, weight)
    g = torch.relu(torch.cat([h, agg], -1) @ mat() + vec("b_last"))
    y = torch.cat([g, feats], -1) @ mat() + vec("b0")
    for i in range(1, len(pack.mlp)):
        y = torch.relu(y) @ mat() + vec(f"mlp_b[{i}]")
    assert next(segs, None) is None
    return y[:, 0]


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("layers,mlp_dims", [(3, (64, 32)), (2, ())])
def test_pack_data_flow_matches_pallas(gnn_type, typed, layers, mlp_dims):
    """The merged products the kernel forms from the pack compute the
    reference kernel's function (1e-5: the sums are grouped otherwise)."""
    cfg = _cfg(gnn_type, num_gnn_layers=layers, mlp_dims=mlp_dims,
               entity_types=ENTITY_TYPE_NAMES if typed else ())
    b, k = 7, 5
    emb, mask, feats = _inputs(b, k, cfg, all_masked_rows=(3,))
    st = None
    if typed:
        st = RNG.integers(-1, len(ENTITY_TYPE_NAMES), (b, k)).astype(np.int32)
    params = ref_lnn_init(jax.random.PRNGKey(8), cfg)
    want = stage2_score_pallas(
        jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(feats),
        ref_flatten(params, gnn_type), gnn_type=gnn_type, interpret=True,
        slot_type=None if st is None else jnp.asarray(st), typed=typed)
    tparams = from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    pack = pack_stage2_params(flatten_stage2_params(tparams, gnn_type), gnn_type, typed)
    got = _packed_stage2(pack, _t(emb), _t(mask), _t(feats), None if st is None else _t(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CHIP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plan_fits_the_h100_and_takes_the_ring_where_it_must(case):
    gnn_type, typed, f, h, k, layers, mlp = case
    pack = pack_stage2_params(flatten_stage2_params(
        _port_params(gnn_type, typed, f, h, layers, mlp), gnn_type), gnn_type, typed)
    plan = stage2_plan(pack, k, H100_OPTIN)
    weights = 4 * (pack.buffer.numel() - pack.vec_floats)
    assert plan.smem_bytes <= H100_OPTIN
    assert plan.whole == (h <= 64) == (weights < H100_OPTIN)
    assert 1 <= plan.rows <= ROWS_PER_BLOCK
    if h <= 64 and not typed:
        assert plan.rows == ROWS_PER_BLOCK
    segs = pack.segments
    assert len(plan.tiles) == len(segs)
    assert plan.n_tiles == sum(-(-s.rows // t) for s, t in zip(segs, plan.tiles))
    if plan.whole:
        assert plan.tiles == tuple(s.rows for s in segs) and plan.depth == len(segs)
    else:
        assert plan.depth >= 2 and plan.stage_floats % 4 == 0
        assert all(1 <= t <= s.rows and t * s.stride <= plan.stage_floats
                   for s, t in zip(segs, plan.tiles))
    if h == 256:   # a 256 x 256 matrix exceeds a stage: row tiles
        assert plan.n_tiles > len(segs)


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
def test_plan_streams_through_the_ring_under_a_small_limit(gnn_type):
    """Any limit that holds the activations and one row tile gives a plan;
    one that does not raises."""
    pack = pack_stage2_params(flatten_stage2_params(
        _port_params(gnn_type, True, 48, 64), gnn_type), gnn_type, True)
    plan = stage2_plan(pack, 8, 48 * 1024)
    assert not plan.whole and plan.smem_bytes <= 48 * 1024
    assert plan.n_tiles > len(pack.segments)
    with pytest.raises(ValueError, match="shared memory"):
        stage2_plan(pack, 8, 8 * 1024)


@pytest.mark.parametrize("what", ["hidden", "mlp", "gnn_type"])
def test_pack_refuses_what_the_kernel_does_not_take(what):
    """Widths past MAX_WIDTH, and a layout of another model type, raise."""
    h, mlp = {"hidden": (257, (8,)), "mlp": (16, (257,)), "gnn_type": (16, (8,))}[what]
    flat = flatten_stage2_params(_port_params("gcn", False, 4, h, mlp=mlp), "gcn")
    with pytest.raises(ValueError):
        pack_stage2_params(flat, "gat" if what == "gnn_type" else "gcn", False)


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
def test_ops_stage2_with_a_pack_equals_without(gnn_type):
    """On the host a pack gives the plain version the same weights, so the
    same bits; a pack of another model type is refused."""
    params = _port_params(gnn_type, False, 8, 32)
    pack = pack_stage2_params(flatten_stage2_params(params, gnn_type), gnn_type, False)
    cfg = _cfg(gnn_type)
    emb, mask, feats = (_t(a) for a in _inputs(5, 4, cfg))
    np.testing.assert_array_equal(
        ops.stage2_score(params, gnn_type, emb, mask, feats, pack=pack).numpy(),
        ops.stage2_score(params, gnn_type, emb, mask, feats).numpy())
    other = "gat" if gnn_type != "gat" else "gcn"
    with pytest.raises(ValueError, match="pack"):
        ops.stage2_score(params, other, emb, mask, feats, pack=pack)

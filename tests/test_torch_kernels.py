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
from repro_torch.kernels.stage2_score import flatten_stage2_params, unpack_stage2_params
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

"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the same parameters (the first layer of the reduced
phi3.5-moe: d=256, 4 experts of d_ff 512, top-2; f32) and the same tokens.

Tolerances: outputs within 1e-5 of their scale (the expert products sum
hundreds of terms of ~1e2 in f32, so an absolute 1e-5 is below f32's own
resolution there), the balance loss within 1e-6.  Cases: capacity for
every assignment; a capacity factor that drops assignments, where the
dropped assignments must be the reference's too; and router ties, broken
toward the lower expert index as ``jax.lax.top_k`` breaks them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.moe import moe_apply as ref_moe_apply
from repro.models.moe import moe_apply_dense_ref as ref_dense
from repro_torch import params as P
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import (moe_apply, moe_apply_dense_ref, moe_capacity,
                                    moe_dispatch, moe_route)

OUT = 1e-5                    # of the output's scale
AUX = 1e-6
T = 64


def _layer(seed=0, **changes):
    ref_cfg = dataclasses.replace(ref_get_config("phi3.5-moe-42b-a6.6b").reduced(), **changes)
    params = RT.init_params(jax.random.PRNGKey(seed), ref_cfg)
    moe = jax.tree_util.tree_map(lambda a: np.array(a[0]), params["groups"]["decoder"]["moe"])
    return ref_cfg, ArchConfig(**dataclasses.asdict(ref_cfg)), moe


def _x(cfg, seed=1, t=T):
    return np.random.default_rng(seed).normal(size=(t, cfg.d_model)).astype(np.float32)


def _both(moe, ref_cfg, cfg, x, full_capacity):
    want, waux = ref_moe_apply(jax.tree_util.tree_map(jnp.asarray, moe), ref_cfg,
                               jnp.asarray(x), full_capacity=full_capacity)
    got, aux = moe_apply(P.from_numpy(moe, "cpu"), cfg, torch.from_numpy(x),
                         full_capacity=full_capacity)
    return (got.numpy(), float(aux)), (np.asarray(want, np.float32), float(waux))


def _close_to_scale(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def test_full_capacity_matches_reference():
    ref_cfg, cfg, moe = _layer()
    x = _x(cfg)
    (got, aux), (want, waux) = _both(moe, ref_cfg, cfg, x, full_capacity=True)
    assert got.shape == (T, cfg.d_model)
    _close_to_scale(got, want, OUT)
    np.testing.assert_allclose(aux, waux, atol=AUX, rtol=0)
    assert 0.5 < aux < 4.0


def _expert_outputs(moe, x):
    """Every expert on every token, f64: [T, E, d]."""
    x = x.astype(np.float64)
    g = np.einsum("td,edf->tef", x, moe["w_gate"].astype(np.float64))
    u = np.einsum("td,edf->tef", x, moe["w_up"].astype(np.float64))
    return np.einsum("tef,efd->ted", g / (1.0 + np.exp(-g)) * u,
                     moe["w_down"].astype(np.float64))


def _ref_dropped(moe, ref_cfg, x):
    """The reference's dropped assignments, read from its outputs alone:
    for each token, the subset of its top-k choices whose gated expert
    outputs make up the difference between the full-capacity and the capped
    output.  Returns a [T, k] bool array, and a [T] mask of the tokens
    whose experts' outputs tell the subsets apart (not a zero token)."""
    k = ref_cfg.experts_per_token
    jm = jax.tree_util.tree_map(jnp.asarray, moe)
    full, _ = ref_moe_apply(jm, ref_cfg, jnp.asarray(x), full_capacity=True)
    capped, _ = ref_moe_apply(jm, ref_cfg, jnp.asarray(x))
    lost = np.asarray(full, np.float64) - np.asarray(capped, np.float64)
    probs = jax.nn.softmax(jnp.asarray(x) @ jm["router"], axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    gates = np.asarray(gates / gates.sum(-1, keepdims=True), np.float64)
    idx = np.asarray(idx)
    y_e = _expert_outputs(moe, x)
    scale = float(np.abs(np.asarray(full)).max())
    subsets = [np.array([(m >> j) & 1 for j in range(k)], bool) for m in range(2 ** k)]
    dropped = np.zeros((x.shape[0], k), bool)
    known = np.zeros(x.shape[0], bool)
    for t in range(x.shape[0]):
        parts = gates[t, :, None] * y_e[t, idx[t]]                 # [k, d]
        resid = [np.abs(lost[t] - parts[s].sum(0)).max() for s in subsets]
        best = int(np.argmin(resid))
        assert resid[best] < 1e-4 * scale, (t, resid)
        known[t] = np.abs(parts).max(-1).min() > 1e-2 * scale
        if known[t]:
            assert sorted(resid)[1] > 1e-2 * scale, (t, resid)   # one subset fits
        dropped[t] = subsets[best]
    return dropped, known


def test_dropping_capacity_matches_reference_and_drops_the_same_assignments():
    ref_cfg, cfg, moe = _layer(moe_capacity_factor=0.5)
    x = _x(cfg, seed=2)
    cap = moe_capacity(cfg, T)
    assert cap == int(-(-2 * T // cfg.num_experts) * 0.5) + 1 == 17
    (got, aux), (want, waux) = _both(moe, ref_cfg, cfg, x, full_capacity=False)
    _close_to_scale(got, want, OUT)
    np.testing.assert_allclose(aux, waux, atol=AUX, rtol=0)

    _, _, idx = moe_route(P.from_numpy(moe, "cpu"), torch.from_numpy(x), cfg.experts_per_token)
    inv, slot_of_assign = moe_dispatch(idx, cfg.num_experts, cap)
    dropped = (slot_of_assign == cfg.num_experts * cap).reshape(T, -1).numpy()
    assert 0 < dropped.sum() < dropped.size
    want, known = _ref_dropped(moe, ref_cfg, x)
    assert known.all()
    np.testing.assert_array_equal(dropped, want)
    # every kept slot holds its token once; the rest of the buffer is empty
    kept = slot_of_assign[slot_of_assign < cfg.num_experts * cap]
    assert len(set(kept.tolist())) == kept.numel() == int((inv < T).sum())


def test_router_ties_break_toward_the_lower_expert():
    """Router columns 1 and 2 equal (every token ties them) and a zero token
    (all four experts tie): the port picks the experts ``jax.lax.top_k``
    picks, and its output, aux and drops follow the reference's."""
    ref_cfg, cfg, moe = _layer(seed=3, moe_capacity_factor=0.75)
    moe["router"][:, 2] = moe["router"][:, 1]
    x = _x(cfg, seed=4)
    x[5] = 0.0
    probs, _, idx = moe_route(P.from_numpy(moe, "cpu"), torch.from_numpy(x),
                              cfg.experts_per_token)
    assert torch.equal(probs[:, 1], probs[:, 2])
    assert idx[5].tolist() == [0, 1]
    # a tie on the last chosen place: the choice itself depends on the order
    second_place = (idx[:, 1] == 1) & (idx[:, 0] != 2)
    assert bool(second_place.any())
    wprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(moe["router"]), axis=-1)
    _, widx = jax.lax.top_k(wprobs, cfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    for full_capacity in (True, False):
        (got, aux), (want, waux) = _both(moe, ref_cfg, cfg, x, full_capacity)
        _close_to_scale(got, want, OUT)
        np.testing.assert_allclose(aux, waux, atol=AUX, rtol=0)
    cap = moe_capacity(cfg, T)
    dropped = (moe_dispatch(idx, cfg.num_experts, cap)[1]
               == cfg.num_experts * cap).reshape(T, -1).numpy()
    want, known = _ref_dropped(moe, ref_cfg, x)
    assert dropped.any() and known.sum() == T - 1    # all but the zero token
    np.testing.assert_array_equal(dropped[known], want[known])


def test_dispatch_ranks_follow_token_order():
    """Two assignments to one expert keep token order (a stable sort): with
    capacity 2 the first two tokens routed to an expert keep their slots."""
    idx = torch.tensor([[0, 1], [0, 2], [0, 1], [1, 0]])
    inv, slot = moe_dispatch(idx, 3, 2)
    assert inv.tolist() == [0, 1, 0, 2, 1, 4]
    assert slot.tolist() == [0, 2, 1, 4, 6, 3, 6, 6]


def test_dense_oracle_matches_reference_and_the_dispatch():
    ref_cfg, cfg, moe = _layer(seed=5)
    x = _x(cfg, seed=6, t=32)
    tm = P.from_numpy(moe, "cpu")
    want = np.asarray(ref_dense(jax.tree_util.tree_map(jnp.asarray, moe), ref_cfg,
                                jnp.asarray(x)), np.float32)
    got = moe_apply_dense_ref(tm, cfg, torch.from_numpy(x)).numpy()
    _close_to_scale(got, want, OUT)
    y, _ = moe_apply(tm, cfg, torch.from_numpy(x), full_capacity=True)
    _close_to_scale(y.numpy(), got, OUT)


@pytest.mark.parametrize("full_capacity", [True, False])
def test_bf16_layer_follows_the_reference_dtypes(full_capacity):
    """In bf16 the router and ``silu`` run in f32, the expert products and
    the combine in bf16: the output is bf16 and agrees with the
    reference's bf16 layer within bf16's rounding (2e-2 of the scale)."""
    ref_cfg, cfg, moe = _layer(seed=7, dtype="bfloat16")
    assert moe["w_gate"].dtype == jnp.bfloat16 and moe["router"].dtype == np.float32
    x = np.asarray(jnp.asarray(_x(cfg, seed=8), jnp.bfloat16))
    want, waux = ref_moe_apply(jax.tree_util.tree_map(jnp.asarray, moe), ref_cfg,
                               jnp.asarray(x), full_capacity=full_capacity)
    got, aux = moe_apply(P.from_numpy(moe, "cpu"), cfg, P.from_numpy(x, "cpu"),
                         full_capacity=full_capacity)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close_to_scale(got.float().numpy(), np.asarray(want, np.float32), 2e-2)
    np.testing.assert_allclose(float(aux), float(waux), atol=AUX, rtol=0)

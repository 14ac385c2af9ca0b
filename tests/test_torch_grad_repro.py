"""The graph aggregations' gradient on the CPU is bit-reproducible at any
intra-op thread count, and the plain mirrors of what the backward kernels
compute follow the reference.

- At 4 intra-op threads (set and restored by a fixture), five backward
  passes through ``ops.csr_spmm``, ``ops.csr_spmm_etype_mean`` and
  ``ops.edge_softmax_agg`` at [2,048 x 64] with 32 slots (30% valid) give
  one bit pattern each, with the graph's reverse-slot index given and
  without it (built from the slots).  Autograd of the plain forward's
  gather ``h[nbr_idx]`` adds with atomics there; the closed forms over the
  reverse-slot index sum in a fixed order.
- ``lnn_loss``'s gradient for gcn, gat and sage at ``lnn_fraud``'s width:
  one bit pattern over ten passes at 4 threads, on the community of the
  Table 3 world (256 orders a community, 24 slots) with the most train
  labels, where autograd's atomics give several patterns for each.
- The plain mirrors of the redesigned backward kernels against
  ``jax.grad`` of ``repro.kernels.ref``'s functions on the same numpy
  inputs, within 1e-5: the per-type mean's backward from the slot weights
  its forward saves, and ``edge_softmax``'s from the row statistics
  (max, sum) its forward saves and c = dout . out.
- A CPU call that also wants the weights' gradient keeps ordinary
  autograd of the plain version, and gets that gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import csr_spmm_ref as jax_csr_spmm_ref
from repro.kernels.ref import edge_softmax_agg_ref as jax_edge_softmax_ref
from repro_torch.core import LNNConfig, lnn_init, lnn_loss
from repro_torch.data import SynthConfig, build_communities, generate_transactions
from repro_torch.kernels import ops, ref
from repro_torch.params import tree_leaves, tree_unflatten

TOL = dict(atol=1e-5, rtol=1e-5)
THREADS = 4
PASSES = 5
LOSS_PASSES = 10
N, D, H, E = 2048, 32, 64, 4


@pytest.fixture
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _graph(n, d, valid, seed):
    """A random padded graph: ``valid`` of the slots valid, the rest
    pointing at row 0 with mask 0 (as stage 1 pads), edge types in [0, E)."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(n, d)) < valid).astype(np.float32)
    idx = (rng.integers(0, n, (n, d)) * mask).astype(np.int32)
    etype = rng.integers(0, E, (n, d)).astype(np.int32)
    return [torch.from_numpy(a) for a in (idx, mask, etype)]


def _bits(tensors):
    return tuple(t.detach().numpy().tobytes() for t in tensors)


def _patterns(fn, leaves, douts):
    """The distinct bit patterns of the gradients of ``fn(*leaves)`` with
    respect to ``leaves`` over PASSES backward passes."""
    seen = set()
    for _ in range(PASSES):
        xs = [t.clone().requires_grad_() for t in leaves]
        outs = fn(*xs)
        seen.add(_bits(torch.autograd.grad(outs, xs, douts)))
    return seen


@pytest.mark.parametrize("with_rev", [True, False])
@pytest.mark.parametrize("op", ["csr_spmm", "csr_spmm_etype_mean", "edge_softmax_agg"])
def test_backward_is_bit_reproducible_at_four_threads(four_threads, op, with_rev):
    idx, mask, etype = _graph(N, D, 0.3, seed=1)
    rev = ref.reverse_slots_ref(idx, mask) if with_rev else None
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))
    if op == "csr_spmm":
        w = mask / mask.sum(-1, keepdim=True).clamp_min(1.0)
        leaves, dout = [h], torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))
        fn = lambda x: ops.csr_spmm(x, idx, w, rev)                         # noqa: E731
    elif op == "csr_spmm_etype_mean":
        leaves, dout = [h], torch.from_numpy(rng.normal(size=(E, N, H)).astype(np.float32))
        fn = lambda x: ops.csr_spmm_etype_mean(x, idx, mask, etype, E, rev)  # noqa: E731
    else:
        s = [torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)) for _ in range(2)]
        bias = torch.from_numpy(0.1 * rng.normal(size=(N, D)).astype(np.float32))
        leaves, dout = [h, *s, bias], torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))
        fn = lambda z, ss, sd, b: ops.edge_softmax_agg(z, ss, sd, idx, mask, b, rev)  # noqa: E731
    assert len(_patterns(fn, leaves, dout)) == 1


@pytest.fixture(scope="module")
def community():
    """The community of the Table 3 world with the most train labels."""
    static, _ = generate_transactions(SynthConfig(num_users=3000, num_rings=50,
                                                  feature_noise=0.8, seed=1))
    batches = build_communities(static, community_size=256, max_deg=24, seed=0)
    graph = max(batches, key=lambda b: int(b.graph.label_mask.sum())).graph
    return graph.to("cpu").with_rev(), graph.features.shape[1]


@pytest.mark.parametrize("gnn", ["gcn", "gat", "sage"])
def test_lnn_loss_gradient_is_bit_reproducible_at_four_threads(four_threads, community, gnn):
    graph, feat_dim = community
    cfg = LNNConfig(gnn_type=gnn, num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                    feat_dim=feat_dim, pos_weight=3.0)
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    seen = set()
    for _ in range(LOSS_PASSES):
        leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(params)]
        loss = lnn_loss(tree_unflatten(params, leaves), cfg, graph)
        seen.add(_bits(torch.autograd.grad(loss, leaves)))
    assert len(seen) == 1


def _small(d, seed):
    """A graph of 160 rows with all-masked rows and a hub of in-degree > 64
    (row 3), as the kernels' ragged cases."""
    idx, mask, etype = _graph(160, d, 0.6, seed)
    mask[:, 0], idx[:, 0] = 1.0, 3
    mask[::7] = 0.0
    etype[5, 0] = E + 1                 # a type outside the vocabulary adds nothing
    return idx, mask, etype, ref.reverse_slots_ref(idx, mask)


@pytest.mark.parametrize("d", [1, 24, 33])
def test_etype_mean_backward_from_saved_weights_follows_jax_grad(d):
    idx, mask, etype, (ptr, slot) = _small(d, seed=d)
    rng = np.random.default_rng(50 + d)
    h = rng.normal(size=(160, 12)).astype(np.float32)
    dout = rng.normal(size=(E, 160, 12)).astype(np.float32)
    j_idx, j_mask, j_et = (jnp.asarray(t.numpy()) for t in (idx, mask, etype))

    def loss(x):        # the reference's per_etype_mean, its plain csr_spmm per type
        outs = []
        for e in range(E):
            w = j_mask * (j_et == e)
            outs.append(jax_csr_spmm_ref(x, j_idx, w / jnp.maximum(w.sum(-1, keepdims=True), 1.0)))
        return jnp.sum(jnp.stack(outs) * dout)

    want = jax.grad(loss)(jnp.asarray(h))
    wslot = ref.etype_mean_weights_ref(mask, etype, E)
    got = ref.csr_spmm_etype_mean_bwd_saved_ref(torch.from_numpy(dout), wslot, etype, ptr, slot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [1, 24, 33])
def test_edge_softmax_backward_from_saved_stats_follows_jax_grad(d):
    idx, mask, _, (ptr, slot) = _small(d, seed=10 + d)
    rng = np.random.default_rng(60 + d)
    z = rng.normal(size=(160, 12)).astype(np.float32)
    s_src, s_dst = (rng.normal(size=160).astype(np.float32) for _ in range(2))
    bias = (0.1 * rng.normal(size=(160, d))).astype(np.float32)
    rows = np.arange(1, 160, 3)          # pre-activations of exactly 0: slope 1
    bias[rows, 0] = 0.0
    s_dst[rows] = -s_src[3]
    dout = rng.normal(size=(160, 12)).astype(np.float32)
    j_idx, j_mask = jnp.asarray(idx.numpy()), jnp.asarray(mask.numpy())

    def loss(z_, ss, sd, b):
        return jnp.sum(jax_edge_softmax_ref(z_, ss, sd, j_idx, j_mask, b) * dout)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (z, s_src, s_dst, bias)))
    t = [torch.from_numpy(a) for a in (z, s_src, s_dst)]
    args = (*t, idx, mask, torch.from_numpy(bias))
    out = ref.edge_softmax_agg_ref(*args)
    stats = ref.edge_softmax_stats_ref(t[1], t[2], idx, mask, args[5])
    assert stats.shape == (160, 2) and stats.dtype == torch.float32
    got = ref.edge_softmax_agg_bwd_saved_ref(torch.from_numpy(dout), out, stats, *args, ptr,
                                             slot)
    for name, g, w in zip(("dz", "ds_src", "ds_dst", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_a_weight_gradient_on_the_cpu_keeps_plain_autograd():
    """Where the weights (or the mask) want a gradient too, the CPU takes
    ordinary autograd of the plain version, which gives it; the
    gradient with respect to ``h`` equals the closed form's."""
    idx, mask, etype, rev = _small(24, seed=4)
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.normal(size=(160, 12)).astype(np.float32)).requires_grad_()
    w = (mask * 0.5).requires_grad_()
    dout = torch.from_numpy(rng.normal(size=(160, 12)).astype(np.float32))
    dh, dw = torch.autograd.grad(ops.csr_spmm(h, idx, w, rev), (h, w), dout)
    assert dw.shape == w.shape and float(dw.abs().sum()) > 0
    np.testing.assert_allclose(dh.numpy(), ref.csr_spmm_bwd_ref(dout, w.detach(), *rev).numpy(),
                               **TOL)
    (dm,) = torch.autograd.grad(ops.csr_spmm_etype_mean(h.detach(), idx, w, etype, E, rev).sum(),
                                w)
    assert dm.shape == w.shape

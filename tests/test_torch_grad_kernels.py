"""The graph kernels' backward, as the port computes it on the card, checked
on the CPU.

- Each closed-form plain backward (``kernels.ref.*_bwd_ref``, what the CUDA
  backward kernels compute) against ``torch.autograd.grad`` of its plain
  forward, within 1e-5 (f32, summed in another order): the single
  ``csr_spmm``, the per-edge-type mean and ``edge_softmax``, at D=1, 24 and
  33, with all-masked rows and a hub row of in-degree > 64.
- ``edge_softmax`` at a logit of exactly 0 against ``jax.grad`` of the
  reference's plain version (``jax.nn.leaky_relu``: slope 1 at 0).
- The reverse-slot index against a direct definition, and the graph that
  carries it (``PaddedGraph.with_rev``; ``PaddedGraph.to`` builds none).
- The ``torch.autograd.Function``s with their CUDA wrappers replaced by the
  plain versions (the forwards saving what the backward kernels read):
  the gradients autograd returns through them, one backward call a
  gradient, and the errors for inputs the backward kernels cannot
  differentiate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import edge_softmax_agg_ref as jax_edge_softmax_ref
from repro_torch.core.graph import PaddedGraph
from repro_torch.kernels import _build, csr_spmm as spmm_mod, edge_softmax as es_mod, ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)
N, H, E = 160, 12, 4
HUB = 3


def _graph(d, seed=0):
    """A random padded graph of N rows and D slots: ~60% valid slots, every
    7th row all-masked, slot 0 of every other row valid and pointing at
    row HUB (in-degree > 64), random edge types in [0, E)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (N, d)).astype(np.int32)
    mask = (rng.uniform(size=(N, d)) < 0.6).astype(np.float32)
    mask[:, 0] = 1.0
    idx[:, 0] = HUB
    mask[::7] = 0.0
    etype = rng.integers(0, E, (N, d)).astype(np.int32)
    t = [torch.from_numpy(a) for a in (idx, mask, etype)]
    return t + list(ref.reverse_slots_ref(t[0], t[1]))


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def test_reverse_index_matches_direct_definition():
    for d in (1, 24, 33):
        idx, mask, _, _, _ = _graph(d, seed=d)
        idx[1, 0] = N + 5                 # out of range: clamped, as the kernels clamp it
        ptr, slot = ref.reverse_slots_ref(idx, mask)
        assert ptr.dtype == slot.dtype == torch.int32
        want = {j: [] for j in range(N)}
        for i in range(N):
            for k in range(d):
                if mask[i, k] > 0:
                    want[min(max(int(idx[i, k]), 0), N - 1)].append(i * d + k)
        assert int(ptr[0]) == 0 and int(ptr[-1]) == slot.numel()
        for j in range(N):
            got = slot[ptr[j]:ptr[j + 1]].tolist()
            assert got == want[j]                       # ascending, no empty slot
        assert int(ptr[HUB + 1] - ptr[HUB]) > 64
        assert bool((mask.flatten()[slot.long()] > 0).all())


def test_graph_carries_the_reverse_index_only_from_with_rev():
    idx, mask, etype, ptr, slot = _graph(24, seed=3)
    zeros_f, zeros_i = np.zeros(N, np.float32), np.zeros(N, np.int32)
    host = PaddedGraph(features=np.zeros((N, 2), np.float32), nbr_idx=idx.numpy(),
                       nbr_mask=mask.numpy(), nbr_etype=etype.numpy(), node_type=zeros_i,
                       snapshot=zeros_i, label=zeros_f, label_mask=zeros_f)
    moved = host.to("cpu")
    assert moved.rev is None           # serving and evaluation move graphs without it
    got = moved.with_rev()
    assert torch.equal(got.rev[0], ptr) and torch.equal(got.rev[1], slot)
    assert got.rev[1].device == moved.nbr_idx.device
    assert torch.equal(got.nbr_idx, moved.nbr_idx)


@pytest.mark.parametrize("d", [1, 24, 33])
def test_csr_spmm_backward_matches_autograd(d):
    idx, mask, _, ptr, slot = _graph(d, seed=d)
    rng = np.random.default_rng(10 + d)
    weights = mask * torch.from_numpy(rng.uniform(0.1, 1.0, (N, d)).astype(np.float32))
    h = _randn(rng, N, H).requires_grad_()
    dout = _randn(rng, N, H)
    (want,) = torch.autograd.grad(ref.csr_spmm_ref(h, idx, weights), h, dout)
    got = ref.csr_spmm_bwd_ref(dout, weights, ptr, slot)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("d", [1, 24, 33])
def test_csr_spmm_etype_mean_backward_matches_autograd(d):
    idx, mask, etype, ptr, slot = _graph(d, seed=d)
    etype[5, 0] = E + 1                         # a type outside the vocabulary adds nothing
    rng = np.random.default_rng(20 + d)
    h = _randn(rng, N, H).requires_grad_()
    dout = _randn(rng, E, N, H)
    out = ref.csr_spmm_etype_mean_ref(h, idx, mask, etype, E)
    (want,) = torch.autograd.grad(out, h, dout)
    got = ref.csr_spmm_etype_mean_bwd_ref(dout, mask, etype, ptr, slot)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _softmax_inputs(d, seed, zero_logits=False):
    idx, mask, _, ptr, slot = _graph(d, seed=seed)
    rng = np.random.default_rng(30 + seed)
    z, s_src, s_dst = _randn(rng, N, H), _randn(rng, N), _randn(rng, N)
    bias = 0.1 * _randn(rng, N, d)
    if zero_logits:
        # slot 0 of every third row: s_src[idx] + s_dst + bias == 0 exactly
        rows = torch.arange(1, N, 3)
        bias[rows, 0] = 0.0
        s_dst[rows] = -s_src[idx[rows, 0].long().clamp(0, N - 1)]
    return [z, s_src, s_dst, idx, mask, bias], (ptr, slot)


def _autograd_softmax(args, dout):
    z, s_src, s_dst, idx, mask, bias = args
    leaves = [t.clone().requires_grad_() for t in (z, s_src, s_dst, bias)]
    out = ref.edge_softmax_agg_ref(leaves[0], leaves[1], leaves[2], idx, mask, leaves[3])
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("d", [1, 24, 33])
def test_edge_softmax_backward_matches_autograd(d):
    args, (ptr, slot) = _softmax_inputs(d, d)
    dout = _randn(np.random.default_rng(40 + d), N, H)
    want = _autograd_softmax(args, dout)
    got = ref.edge_softmax_agg_bwd_ref(dout, *args, ptr, slot)
    for name, g, w in zip(("dz", "ds_src", "ds_dst", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)


def test_edge_softmax_gradient_at_a_zero_logit_follows_the_reference():
    """At a pre-activation of exactly 0 ``jax.nn.leaky_relu``'s slope is 1
    (torch's ``F.leaky_relu`` backward gives 0.2): the plain forward's
    autograd and the closed-form backward both take 1, as ``jax.grad``."""
    d = 24
    args, (ptr, slot) = _softmax_inputs(d, 2, zero_logits=True)
    z, s_src, s_dst, idx, mask, bias = args
    pre = s_src[idx.long()] + s_dst[:, None] + bias
    assert int(((pre == 0) & (mask > 0)).sum()) >= 40
    dout = _randn(np.random.default_rng(5), N, H)

    def loss(z_, ss, sd, b):
        out = jax_edge_softmax_ref(z_, ss, sd, jnp.asarray(idx.numpy()),
                                   jnp.asarray(mask.numpy()), b)
        return jnp.sum(out * jnp.asarray(dout.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.numpy()) for t in (z, s_src, s_dst, bias)))
    closed = ref.edge_softmax_agg_bwd_ref(dout, *args, ptr, slot)
    auto = _autograd_softmax(args, dout)
    for name, w, c, a in zip(("dz", "ds_src", "ds_dst", "dbias"), want, closed, auto):
        np.testing.assert_allclose(c.numpy(), np.asarray(w), err_msg=name, **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.fixture
def plain_wrappers(monkeypatch):
    """The CUDA wrappers replaced by their plain versions, each counting
    under its own name, as in a rehearsal of the card's path on the CPU:
    the forwards with what they save under grad, the backwards reading it,
    one count a call."""
    def counted(name, fn):
        def run(*a, **kw):
            _build.LAUNCHES[name] += 1
            return fn(*a, **kw)
        return run

    def etype_mean(h, idx, mask, et, num_types, save_weights=False):
        out = ref.csr_spmm_etype_mean_ref(h, idx, mask, et, num_types)
        return (out, ref.etype_mean_weights_ref(mask, et, num_types)) if save_weights else out

    def softmax(z, ss, sd, idx, mask, bias, save_stats=False):
        out = ref.edge_softmax_agg_ref(z, ss, sd, idx, mask, bias)
        return (out, ref.edge_softmax_stats_ref(ss, sd, idx, mask, bias)) if save_stats else out

    fwd = {"csr_spmm_cuda": counted("csr_spmm", ref.csr_spmm_ref),
           "csr_spmm_etype_mean_cuda": counted("csr_spmm", etype_mean),
           "edge_softmax_agg_cuda": counted("edge_softmax", softmax)}
    for name, fake in fwd.items():     # in the wrappers' modules and in ops
        monkeypatch.setattr(es_mod if name.startswith("edge") else spmm_mod, name, fake)
        monkeypatch.setattr(ops, name, fake)
    monkeypatch.setattr(spmm_mod, "csr_spmm_bwd_cuda",
                        counted("csr_spmm_bwd", ref.csr_spmm_bwd_ref))
    monkeypatch.setattr(spmm_mod, "csr_spmm_etype_mean_bwd_cuda",
                        counted("csr_spmm_bwd", ref.csr_spmm_etype_mean_bwd_saved_ref))
    monkeypatch.setattr(es_mod, "edge_softmax_agg_bwd_cuda",
                        counted("edge_softmax_bwd", ref.edge_softmax_agg_bwd_saved_ref))
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    _build.reset_launches()
    yield
    _build.reset_launches()


def _grads(fn, leaves, dout):
    leaves = [t.clone().requires_grad_() for t in leaves]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


def test_functions_take_gradients_from_the_backward_wrappers(plain_wrappers):
    d = 24
    idx, mask, etype, ptr, slot = _graph(d, seed=7)
    rng = np.random.default_rng(8)
    h = _randn(rng, N, H)
    w = mask / mask.sum(-1, keepdim=True).clamp_min(1.0)
    dout, dout_e = _randn(rng, N, H), _randn(rng, E, N, H)
    rev = (ptr, slot)

    got = _grads(lambda x: ops.csr_spmm(x, idx, w, rev), [h], dout)
    want = _grads(lambda x: ref.csr_spmm_ref(x, idx, w), [h], dout)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)

    got = _grads(lambda x: ops.csr_spmm_etype_mean(x, idx, mask, etype, E, rev), [h], dout_e)
    want = _grads(lambda x: ref.csr_spmm_etype_mean_ref(x, idx, mask, etype, E), [h], dout_e)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)

    args, _ = _softmax_inputs(d, 7)
    z, s_src, s_dst, _, _, bias = args

    def via_ops(z_, ss, sd, b):
        return ops.edge_softmax_agg(z_, ss, sd, idx, mask, b, rev)

    def plain(z_, ss, sd, b):
        return ref.edge_softmax_agg_ref(z_, ss, sd, idx, mask, b)

    for g, w_ in zip(_grads(via_ops, [z, s_src, s_dst, bias], dout),
                     _grads(plain, [z, s_src, s_dst, bias], dout)):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), **TOL)
    assert _build.LAUNCHES["csr_spmm"] == 2 and _build.LAUNCHES["csr_spmm_bwd"] == 2
    assert _build.LAUNCHES["edge_softmax"] == 1 and _build.LAUNCHES["edge_softmax_bwd"] == 1

    # no gradient wanted: the forward wrappers alone, no Function
    with torch.no_grad():
        ops.csr_spmm(h.requires_grad_(), idx, w)
    assert _build.LAUNCHES["csr_spmm"] == 3 and _build.LAUNCHES["csr_spmm_bwd"] == 2


def test_functions_refuse_what_the_backward_kernels_cannot_differentiate(plain_wrappers):
    idx, mask, etype, ptr, slot = _graph(24, seed=9)
    rng = np.random.default_rng(9)
    h = _randn(rng, N, H).requires_grad_()
    rev = (ptr, slot)
    w = mask.clone().requires_grad_()
    with pytest.raises(ValueError, match="no gradient with respect to weights"):
        ops.csr_spmm(h, idx, w, rev)
    with pytest.raises(ValueError, match="no gradient with respect to weights"):
        ops.csr_spmm(h.detach(), idx, w, rev)
    with pytest.raises(ValueError, match="no gradient with respect to nbr_mask"):
        ops.csr_spmm_etype_mean(h, idx, w, etype, E, rev)
    z, s = _randn(rng, N, H).requires_grad_(), _randn(rng, N)
    with pytest.raises(ValueError, match="no gradient with respect to nbr_mask"):
        ops.edge_softmax_agg(z, s, s, idx, w, mask, rev)
    with pytest.raises(ValueError, match="reverse-slot index"):
        ops.csr_spmm(h, idx, mask)
    with pytest.raises(ValueError, match="reverse-slot index"):
        ops.edge_softmax_agg(z, s, s, idx, mask, mask)
    with pytest.raises(TypeError, match="float32"):
        ops.csr_spmm(h.detach().to(torch.bfloat16).requires_grad_(), idx, mask, rev)
    assert all(v == 0 for v in _build.LAUNCHES.values())

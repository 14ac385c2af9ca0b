"""The backward of the zoo's two training kernels on the CPU: the plain
closed forms in ``repro_torch.kernels.ref`` (``attention_lse_ref``,
``flash_attention_bwd_ref``, ``ssd_scan_bwd_ref``), which the backward
kernels on the card compute and which the ``autograd.Function``s
(``FlashAttention``, ``SsdScan``) take on the CPU.

They are held against ``torch.autograd`` of the port's plain forward and
against ``jax.grad`` of the reference's XLA paths
(``repro.models.common.blockwise_attention``, ``repro.kernels.ref.
ssd_chunked_ref`` and, where the chunk does not divide S, ``ssd_scan_ref``),
on the same inputs drawn with numpy.  f32 with TF32 off: 2e-5 for attention
(the kernel tolerance of the repo's attention tests), 1e-4 of each
gradient's scale for the SSD scan (its sums over B, S and H cancel); a
bf16 attention case 2e-2 of the scale.  Two backward passes at four
intra-op threads give the same bits.

Where the clip at -60 is active, ``da`` (one sum a head over every row) can
cancel to a small fraction of its terms; the f32 rounding of either side is
then a larger share of it (at dt up to 4-5 and -a up to 8.5, the
reference's f32 ``da`` is 3e-4 to 9e-4 of its scale from an f64 evaluation
of the same closed form, the port's 1e-5 to 5e-4).  The clip cases use dt
and a within the model's range, where the clip is active and ``da`` does
not cancel so far."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK
from repro.models import common as RC
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ref import blockwise_attention
from repro_torch.kernels.ssd_scan import ssd_scan_plain

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
SSD_TOL = 1e-4      # of each gradient's scale


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_to_scale(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol} of the scale {scale:.3e}"


def _attn_inputs(b, hq, hkv, sq, sk, dh, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh)))
    dout = rng.normal(size=(b, hq, sq, dh)).astype(np.float32)
    return q, k, v, dout


# (B, Hq, Hkv, Sq, Sk, Dh, causal, window): causal; a window across the
# 512-key blocks' edges; non-causal with Sq != Sk (an encoder, a cross
# layer); a ragged Sk; GQA rep 1, 4 and 8; Dh 64 and 128
ATTN_CASES = [
    (2, 4, 4, 96, 96, 64, True, None),
    (1, 8, 2, 80, 80, 64, True, 24),
    (2, 4, 1, 48, 72, 64, False, None),
    (1, 8, 8, 40, 17, 128, False, None),
    (1, 8, 1, 33, 77, 128, True, None),
    (2, 16, 2, 64, 64, 64, True, None),
    (1, 4, 2, 70, 130, 128, True, 50),
]
ATTN_IDS = ["causal-rep1", "window-rep4", "full-sq<sk-rep4", "full-ragged-sk-dh128",
            "causal-sq<sk-rep8-dh128", "causal-rep8", "window-sq<sk-dh128"]


@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_attention_bwd_matches_autograd_and_jax(case):
    b, hq, hkv, sq, sk, dh, causal, window = case
    q, k, v, dout = _attn_inputs(b, hq, hkv, sq, sk, dh)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = blockwise_attention(tq, tk, tv, causal=causal, window=window, block_k=min(512, sk))
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    lse = ref.attention_lse_ref(tq.detach(), tk.detach(), causal, window)
    got = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                      torch.from_numpy(dout), lse, causal, window)

    def fwd(q, k, v):
        return RC.blockwise_attention(q, k, v, causal=causal, window=window,
                                      block_k=min(512, sk))
    _, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    for name, g, a, w in zip("qkv", got, auto, want):
        torch.testing.assert_close(g, a, **ATTN_TOL, msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_TOL,
                                   err_msg=f"d{name} vs jax")


def test_attention_lse_is_the_rows_logsumexp():
    q, k, _, _ = _attn_inputs(2, 4, 2, 50, 70, 64)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    lse = ref.attention_lse_ref(tq, tk, True, 30)
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk.repeat_interleave(2, 1)) * 64 ** -0.5
    qpos = torch.arange(50)[:, None] + 20
    kpos = torch.arange(70)[None, :]
    s = torch.where((kpos <= qpos) & (kpos > qpos - 30), s, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-6)


def test_attention_bwd_rows_with_no_valid_key():
    """Causal with Sq > Sk: the first Sq - Sk rows see no key, and their
    output is the mean of v (the forward's rule), a constant in q and k."""
    q, k, v, dout = _attn_inputs(1, 2, 1, 40, 24, 64)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ref.mha_ref(tq, tk, tv, causal=True)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    lse = ref.attention_lse_ref(tq.detach(), tk.detach(), True)
    assert torch.allclose(lse[:, :, :16], torch.full((1, 2, 16), float(np.log(24))))
    got = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                      torch.from_numpy(dout), lse, True)
    assert torch.equal(got[0][:, :, :16], torch.zeros(1, 2, 16, 64))
    for g, a in zip(got, auto):
        torch.testing.assert_close(g, a, **ATTN_TOL)


def test_attention_bwd_bf16_within_its_tolerance():
    q, k, v, dout = _attn_inputs(1, 8, 2, 64, 64, 64, seed=3)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v, dout)]
    out = flash_attention_plain(*bf[:3], True, None)
    lse = ref.attention_lse_ref(*bf[:2], True)
    got = ref.flash_attention_bwd_ref(*bf[:3], out, bf[3], lse, True)
    tq, tk, tv = (t.float().requires_grad_() for t in bf[:3])
    want = torch.autograd.grad(ref.mha_ref(tq, tk, tv), (tq, tk, tv), bf[3].float())
    for g, w, t in zip(got, want, bf[:3]):
        assert g.dtype == torch.bfloat16
        _close_to_scale(g.float().numpy(), w.numpy(), 2e-2)


def _ssd_inputs(b, s, h, p, n, seed=0, dt_hi=0.2, a_hi=1.5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, dt_hi, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 0.5 + a_hi, size=h).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    d = rng.normal(size=h).astype(np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    return (x, dt, a, bm, cm, d), dy


# (B, S, H, P, N, chunk, dt range, a range): the model's chunk of 64 over
# two chunks; mamba2's N=128 at a short chunk; the clip at -60 active
# within chunks (large dt·a); an S that 64 does not divide (the reference's
# sequential recurrence, the port's backward on padded chunks of 64); S
# shorter than 64 (one chunk of S)
SSD_CASES = [
    (2, 128, 3, 16, 8, 64, 0.2, 1.5),
    (1, 96, 2, 8, 128, 32, 0.2, 1.5),
    (2, 128, 2, 8, 6, 64, 1.0, 4.0),
    (1, 100, 2, 8, 5, 64, 0.2, 1.5),
    (2, 40, 3, 6, 4, 64, 0.2, 1.5),
]
SSD_IDS = ["two-chunks", "n128-chunk32", "clip-active", "s-not-divisible", "one-short-chunk"]


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_bwd_matches_autograd_and_jax(case):
    b, s, h, p, n, chunk, dt_hi, a_hi = case
    ins, dy = _ssd_inputs(b, s, h, p, n, dt_hi=dt_hi, a_hi=a_hi)
    tin = [torch.from_numpy(x).requires_grad_() for x in ins]
    y = ssd_scan_plain(*tin, chunk=chunk)
    auto = torch.autograd.grad(y, tin, torch.from_numpy(dy))
    bwd_chunk = chunk if s % chunk == 0 else 64
    got = ref.ssd_scan_bwd_ref(*(t.detach() for t in tin), torch.from_numpy(dy),
                               chunk=bwd_chunk)
    if s % chunk == 0:
        fwd = lambda *a: RK.ssd_chunked_ref(*a, chunk=chunk)  # noqa: E731
    elif s < 64:
        fwd = lambda *a: RK.ssd_chunked_ref(*a, chunk=s)  # noqa: E731
    else:
        fwd = RK.ssd_scan_ref
    _, vjp = jax.vjp(fwd, *(jnp.asarray(x) for x in ins))
    want = vjp(jnp.asarray(dy))
    for name, g, a, w in zip(("x", "dt", "a", "b", "c", "d"), got, auto, want):
        _close_to_scale(g.numpy(), np.asarray(w), SSD_TOL, f"d{name} vs jax")
        _close_to_scale(g.numpy(), a.numpy(), SSD_TOL, f"d{name} vs autograd")


def test_ssd_bwd_gradient_is_zero_where_the_clip_is_active():
    """A head decays by more than 60 within the chunk: the decays between
    its far rows are clipped at exp(-60), constants, so the reference gives
    dt and a a gradient only through the rows within reach.  (Unclipped,
    those terms would weigh less than exp(-60) ~ 9e-27 of the others: the
    case checks the regime, where the sums over rows cancel most, not the
    indicator, which no f32 result can show.)"""
    ins, dy = _ssd_inputs(1, 64, 2, 4, 4, dt_hi=1.0, a_hi=8.0)
    _, vjp = jax.vjp(lambda *a: RK.ssd_chunked_ref(*a, chunk=64), *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(dy))
    got = ref.ssd_scan_bwd_ref(*map(torch.from_numpy, ins), torch.from_numpy(dy))
    cum = np.cumsum(ins[1][0] * ins[2], axis=0)
    assert (cum[-1] < -60.0).any()
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w), SSD_TOL)


def test_ssd_bwd_without_d_skip():
    ins, dy = _ssd_inputs(1, 64, 2, 4, 4)
    got = ref.ssd_scan_bwd_ref(*map(torch.from_numpy, ins[:5]), None, torch.from_numpy(dy))
    assert got[-1] is None
    _, vjp = jax.vjp(lambda *a: RK.ssd_chunked_ref(*a, None, chunk=64),
                     *map(jnp.asarray, ins[:5]))
    for g, w in zip(got[:5], vjp(jnp.asarray(dy))):
        _close_to_scale(g.numpy(), np.asarray(w), SSD_TOL)


def test_plain_backwards_give_the_same_bits_at_four_threads():
    q, k, v, dout = map(torch.from_numpy, _attn_inputs(2, 8, 2, 96, 96, 64))
    ins, dy = _ssd_inputs(2, 128, 4, 16, 8)
    ins, dy = [torch.from_numpy(x) for x in ins], torch.from_numpy(dy)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        out = flash_attention_plain(q, k, v, True, 40)
        lse = ref.attention_lse_ref(q, k, True, 40)
        runs = [ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, True, 40)
                for _ in range(2)]
        ssd = [ref.ssd_scan_bwd_ref(*ins, dy) for _ in range(2)]
    finally:
        torch.set_num_threads(n)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(torch.equal(a, b) for a, b in zip(*ssd))


def test_dispatch_takes_the_autograd_functions_under_grad_on_cpu():
    """Under grad ``ops`` takes ``FlashAttention`` and ``SsdScan``, whose
    forward is the no-grad plain path's bit for bit and whose backward is
    the closed form; without grad it takes the plain path itself."""
    q, k, v, dout = map(torch.from_numpy, _attn_inputs(1, 4, 2, 64, 64, 64))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=None)
    assert out.grad_fn.name() == "FlashAttentionBackward"
    assert torch.equal(out.detach(), ops.flash_attention(q, k, v))
    got = torch.autograd.grad(out, (tq, tk, tv), dout)
    want = ref.flash_attention_bwd_ref(q, k, v, out.detach(), dout,
                                       ref.attention_lse_ref(q, k), True, None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    ins, dy = _ssd_inputs(1, 70, 2, 8, 4)
    ins, dy = [torch.from_numpy(x) for x in ins], torch.from_numpy(dy)
    tin = [t.clone().requires_grad_() for t in ins]
    y = ops.ssd_scan(*tin, chunk=64)
    assert y.grad_fn.name() == "SsdScanBackward"
    assert torch.equal(y.detach(), ops.ssd_scan(*ins, chunk=64))
    got = torch.autograd.grad(y, tin, dy)
    want = ref.ssd_scan_bwd_ref(*ins, dy, chunk=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # a gradient for some inputs only: the others' are computed and dropped
    tx = ins[0].clone().requires_grad_()
    (gx,) = torch.autograd.grad(ops.ssd_scan(tx, *ins[1:], chunk=64), (tx,), dy)
    assert torch.equal(gx, want[0])

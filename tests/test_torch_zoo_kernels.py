"""The port's zoo kernels on the CPU path (``kernels.ops.ssd_scan``,
``flash_attention``, ``gqa_decode`` with CPU tensors, i.e. their plain
versions) against the reference's Pallas kernels in interpret mode and its
plain oracles, on the same numpy inputs.

Tolerances are the reference tests' (``tests/test_kernels.py``): 2e-5 in
f32 for the attention kernels (the frameworks sum in other orders), 2e-2
in bf16; the SSD scan is compared relative to the output's scale at 3e-5
(the chunked and sequential forms accumulate the state differently), and
the chunked form against the sequential one at 2e-5 / rtol 1e-3, as there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.gqa_decode import gqa_decode_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ref import blockwise_attention

RNG = np.random.default_rng(12)
F32 = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ssd_inputs(b, s, h, p, n):
    return (RNG.normal(size=(b, s, h, p)).astype(np.float32),
            RNG.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
            (-RNG.uniform(0.5, 2.0, h)).astype(np.float32),
            RNG.normal(size=(b, s, n)).astype(np.float32),
            RNG.normal(size=(b, s, n)).astype(np.float32),
            RNG.normal(size=h).astype(np.float32))


def _close_to_scale(got, want, atol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ------------------------------------------------------------------ ssd_scan
@pytest.mark.parametrize("s,chunk", [(128, 64), (256, 128)])
@pytest.mark.parametrize("h,p,n", [(4, 64, 32), (2, 32, 64)])
def test_ssd_scan_matches_pallas_and_chunked_ref(s, chunk, h, p, n):
    args = _ssd_inputs(2, s, h, p, n)
    got = ops.ssd_scan(*(_t(a) for a in args)).numpy()
    pallas = np.asarray(ssd_scan_pallas(*(jnp.asarray(a) for a in args), chunk=chunk,
                                        interpret=True))
    chunked = np.asarray(R.ssd_chunked_ref(*(jnp.asarray(a) for a in args), chunk=64))
    _close_to_scale(got, pallas, 3e-5)
    np.testing.assert_allclose(got, chunked, **F32)


@pytest.mark.parametrize("s", [77, 40])
def test_ssd_scan_ragged_takes_reference_xla_choice(s):
    """S=77: no chunk divides it, so both sides run the sequential
    recurrence; S=40 < 64: one chunk of the whole sequence."""
    args = _ssd_inputs(2, s, 3, 16, 24)
    got = ops.ssd_scan(*(_t(a) for a in args)).numpy()
    want = np.asarray(R.ssd_scan_ref(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-3)


def test_ssd_plain_versions_match_reference_oracles():
    x, dt, a, b, c, d = _ssd_inputs(2, 192, 3, 16, 24)
    jargs = [jnp.asarray(v) for v in (x, dt, a, b, c)]
    targs = [_t(v) for v in (x, dt, a, b, c)]
    np.testing.assert_allclose(ref.ssd_scan_ref(*targs, _t(d)).numpy(),
                               np.asarray(R.ssd_scan_ref(*jargs, jnp.asarray(d))), **F32)
    np.testing.assert_allclose(ref.ssd_chunked_ref(*targs, chunk=64).numpy(),
                               np.asarray(R.ssd_chunked_ref(*jargs, chunk=64)), **F32)
    # and the chunked form against the sequential recurrence
    np.testing.assert_allclose(ref.ssd_chunked_ref(*targs, chunk=64).numpy(),
                               ref.ssd_scan_ref(*targs).numpy(), atol=2e-5, rtol=1e-3)


def test_ssd_chunked_bf16_compute_dtype_matches_reference():
    x, dt, a, b, c, d = _ssd_inputs(1, 128, 2, 16, 16)
    got = ref.ssd_chunked_ref(*(_t(v) for v in (x, dt, a, b, c)), chunk=64,
                              compute_dtype=torch.bfloat16).numpy()
    want = np.asarray(R.ssd_chunked_ref(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                                        chunk=64, compute_dtype=jnp.bfloat16))
    _close_to_scale(got, want, 2e-2)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 512, 4, 64, 64, 128),   # 8 chunks of the kernel's 64: the state carried 7 times
    (2, 200, 4, 64, 64, 40),    # a ragged last chunk (200 = 3 x 64 + 8)
    (1, 256, 4, 64, 128, 64),   # N = 128 (mamba2-370m)
])
def test_ssd_mma_model_matches_pallas_and_f32_chunked(b, s, h, p, n, chunk):
    """The plain model of the bf16 kernel's roundings (W, the state's copy
    for C·S, the state update's operand) against the reference's Pallas
    kernel in interpret mode and its f32 chunked form, on inputs rounded to
    bf16.  Each rounding is relative 2^-9, and the output's own rounding to
    bf16 is at most 2^-8 of the scale: the error expected is below 6e-3 of
    the output's scale (3.4e-3 to 4.9e-3 on these inputs), held at 2e-2."""
    x, dt, a, bm, cm, d = _ssd_inputs(b, s, h, p, n)
    x, bm, cm = (_t(v).to(torch.bfloat16) for v in (x, bm, cm))
    got = ref.ssd_scan_mma_ref(x, _t(dt), _t(a), bm, cm, _t(d))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float().numpy()
    jargs = [jnp.asarray(v.float().numpy()) for v in (x,)] + [jnp.asarray(dt), jnp.asarray(a)] \
        + [jnp.asarray(v.float().numpy()) for v in (bm, cm)] + [jnp.asarray(d)]
    pallas = np.asarray(ssd_scan_pallas(*jargs, chunk=chunk, interpret=True))
    chunked = np.asarray(R.ssd_chunked_ref(*jargs, chunk=chunk))
    for want in (pallas, chunked):
        _close_to_scale(got, want, 2e-2)


def test_ssd_mma_model_rounds_where_the_kernel_rounds():
    """On f32 inputs that bf16 holds exactly, and with an f32 result, the
    model differs from the f32 chunked form by more than f32 rounding (its
    roundings are there) and by less than 6e-3 of the output's scale (they
    are all it adds)."""
    x, dt, a, bm, cm, d = _ssd_inputs(1, 192, 2, 16, 64)
    x, bm, cm = (_t(v).to(torch.bfloat16).float() for v in (x, bm, cm))
    args = (x, _t(dt), _t(a), bm, cm, _t(d))
    model = ref.ssd_scan_mma_ref(*args).numpy()
    chunked = ref.ssd_chunked_ref(*args, chunk=64).numpy()
    scale = float(np.abs(chunked).max())
    gap = float(np.abs(model - chunked).max()) / scale
    assert 1e-5 < gap < 6e-3
    _close_to_scale(model, np.asarray(R.ssd_chunked_ref(
        *(jnp.asarray(v.numpy()) for v in args), chunk=64)), 6e-3)


# ------------------------------------------------------------ flash_attention
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 16])
def test_flash_attention_matches_pallas(hq, hkv, causal, window):
    b, s, dh = 2, 128, 64
    q, k, v = (RNG.normal(size=(b, h, s, dh)).astype(np.float32)
               for h in (hq, hkv, hkv))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, block_q=64,
                                  block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    oracle = R.mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)


@pytest.mark.parametrize("sq,sk,block_k", [(100, 130, 64), (48, 48, 512)])
def test_blockwise_attention_ragged_matches_reference(sq, sk, block_k):
    """Keys padded to the block and masked, q aligned to the keys' end."""
    from repro.models.common import blockwise_attention as ref_blockwise

    q = RNG.normal(size=(1, 4, sq, 64)).astype(np.float32)
    k, v = (RNG.normal(size=(1, 2, sk, 64)).astype(np.float32) for _ in range(2))
    got = blockwise_attention(_t(q), _t(k), _t(v), causal=True, window=32, block_k=block_k)
    want = ref_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                         window=32, block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_attention_bf16_matches_pallas():
    b, hq, hkv, s, dh = 1, 4, 2, 128, 64
    q, k, v = (RNG.normal(size=(b, h, s, dh)).astype(np.float32) for h in (hq, hkv, hkv))
    got = ops.flash_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = flash_attention_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                  block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_mha_ref_matches_reference():
    q = RNG.normal(size=(2, 4, 40, 32)).astype(np.float32)
    k, v = (RNG.normal(size=(2, 2, 56, 32)).astype(np.float32) for _ in range(2))
    got = ref.mha_ref(_t(q), _t(k), _t(v), causal=True, window=24).numpy()
    want = R.mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=24)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


# ---------------------------------------------------------------- gqa_decode
@pytest.mark.parametrize("hq,hkv,s", [(8, 2, 384), (4, 4, 256)])
@pytest.mark.parametrize("window", [None, 16])
def test_gqa_decode_matches_pallas(hq, hkv, s, window):
    b, dh = 4, 64
    q = RNG.normal(size=(b, hq, dh)).astype(np.float32)
    k, v = (RNG.normal(size=(b, hkv, s, dh)).astype(np.float32) for _ in range(2))
    kv_len = np.array([1, 37, s // 2 + 3, s], np.int32)
    got = ops.gqa_decode(_t(q), _t(k), _t(v), kv_len=_t(kv_len), window=window).numpy()
    want = gqa_decode_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kv_len=jnp.asarray(kv_len), window=window, block_k=128,
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    oracle = R.gqa_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_len=jnp.asarray(kv_len), window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)


def test_gqa_decode_full_cache_when_kv_len_is_none():
    q = RNG.normal(size=(2, 4, 64)).astype(np.float32)
    k, v = (RNG.normal(size=(2, 2, 96, 64)).astype(np.float32) for _ in range(2))
    got = ops.gqa_decode(_t(q), _t(k), _t(v), window=32).numpy()
    want = gqa_decode_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=32,
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_cpu_dispatch_launches_no_kernel():
    before = dict(_build.LAUNCHES)
    x, dt, a, b, c, d = _ssd_inputs(1, 64, 2, 16, 16)
    ops.ssd_scan(*(_t(v) for v in (x, dt, a, b, c, d)))
    q = _t(RNG.normal(size=(1, 2, 64, 64)).astype(np.float32))
    ops.flash_attention(q, q, q)
    ops.gqa_decode(q[:, :, 0].contiguous(), q, q)
    assert _build.LAUNCHES == before

"""The edges of the port's attention kernels, on the CPU.

``gqa_decode``: the plain version (``ref.gqa_decode_ref``) and the CUDA
kernel's split/combine arithmetic emulated with tensor ops
(``ref.gqa_decode_split_ref``: 64-row splits, each with its own max and its
own bf16 rounding of the probabilities, merged in split order) against the
reference's Pallas kernel in interpret mode, where no position is valid
(kv_len 0; a window that lies wholly past S), at kv_len 1 and at the
splits' edges, f32 and bf16, GQA rep 1, 4 and 16, Dh 64 and 128.  With no
valid position the reference's weights are all equal and the result is the
mean of v over the S slots, which the split arithmetic must give too.

``flash_attention``: the plain version (``blockwise_attention``, against
which ``chip_smoke.py`` holds the tensor-core kernel on the card) against
the reference's O(S^2) oracle at the shapes of those card checks: fewer
rows than one tile, ragged tiles at Dh 128, windows across tile edges with
q shorter and longer than the keys.

Tolerances: 1e-5 in f32 (summation order), 2e-2 in bf16 (the
probabilities are rounded to bf16 against different maxima).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.gqa_decode import gqa_decode_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.gqa_decode import CHUNK
from repro_torch.kernels.ref import blockwise_attention

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
B, HKV = 3, 2

#: (S, kv_len per sequence, window)
DECODE_CASES = {
    "kv_len_zero": (96, [0, 5, 96], None),
    "past_end_window": (96, [0, 100, 120], 16),   # 100: partly inside; 120: wholly past S
    "kv_len_one": (96, [1, 1, 1], None),
    "split_edges": (2 * CHUNK + 32, [CHUNK, CHUNK + 1, 2 * CHUNK], None),
    "split_edges_window": (2 * CHUNK + 32, [CHUNK, CHUNK + 1, 2 * CHUNK + 2], CHUNK),
}


@functools.cache
def _decode_case(case, dtype, rep, dh):
    """Inputs (numpy f32, already rounded to ``dtype``) and the Pallas
    kernel's output in f32, cached across the tests of one worker."""
    s, lens, window = DECODE_CASES[case]
    rng = np.random.default_rng([rep, dh, sorted(DECODE_CASES).index(case),
                                 dtype == "bfloat16"])
    q = rng.normal(size=(B, HKV * rep, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, HKV, s, dh)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = (np.array(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
    kv_len = np.asarray(lens, np.int32)
    want = gqa_decode_pallas(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             kv_len=jnp.asarray(kv_len), window=window, interpret=True)
    return q, k, v, kv_len, window, np.asarray(want, np.float32)


def _torch_args(q, k, v, kv_len, dtype):
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [torch.from_numpy(kv_len)]


_decode_params = pytest.mark.parametrize("case", sorted(DECODE_CASES))
_dtype_params = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
_rep_params = pytest.mark.parametrize("rep", [1, 4, 16])
_dh_params = pytest.mark.parametrize("dh", [64, 128])


@_decode_params
@_dtype_params
@_rep_params
@_dh_params
def test_gqa_decode_plain_matches_pallas(case, dtype, rep, dh):
    q, k, v, kv_len, window, want = _decode_case(case, dtype, rep, dh)
    got = ref.gqa_decode_ref(*_torch_args(q, k, v, kv_len, dtype), window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@_decode_params
@_dtype_params
@_rep_params
@_dh_params
def test_gqa_decode_split_arithmetic_matches_pallas(case, dtype, rep, dh):
    q, k, v, kv_len, window, want = _decode_case(case, dtype, rep, dh)
    got = ref.gqa_decode_split_ref(*_torch_args(q, k, v, kv_len, dtype), window=window,
                                   chunk=CHUNK)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    # a sequence with no valid position gets the mean of v over the S slots
    s = k.shape[2]
    lo = kv_len - window if window else np.zeros_like(kv_len)
    for i in np.flatnonzero(np.maximum(lo, 0) >= np.minimum(kv_len, s)):
        mean_v = np.repeat(v[i].mean(axis=1), rep, axis=0)
        np.testing.assert_allclose(got[i].float().numpy(), mean_v, **TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh,window", [
    (2, 4, 4, 1, 1, 64, None),
    (2, 4, 4, 17, 17, 64, None),
    (2, 4, 4, 65, 65, 64, None),
    (1, 8, 8, 300, 300, 128, None),
    (1, 16, 4, 150, 250, 64, 64),
    (1, 8, 2, 130, 100, 128, 40),
])
def test_flash_plain_matches_reference_at_tile_edges(b, hq, hkv, sq, sk, dh, window):
    rng = np.random.default_rng([sq, sk, dh])
    q = rng.normal(size=(b, hq, sq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, sk, dh)).astype(np.float32) for _ in range(2))
    got = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                              window=window, block_k=min(512, sk))
    want = R.mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                     window=window)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])

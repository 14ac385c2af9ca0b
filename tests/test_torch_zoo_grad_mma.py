"""The plain models of the zoo's two bf16 backward kernels on the CPU:
``repro_torch.kernels.ref.flash_attention_bwd_mma_ref`` and
``ssd_scan_bwd_mma_ref``, each the tensor-core kernel's arithmetic (its
bf16 roundings, its f32 sums, the scan's chunk-parallel states), which
``chip_smoke.py`` holds the kernels against on the card.

Each model is held, on the same inputs drawn with numpy, against the
closed form of its f32 kernel (``flash_attention_bwd_ref``,
``ssd_scan_bwd_ref``) with f32 inputs, where it rounds nothing: within 1e-5
of each gradient's scale; and with bf16 inputs against ``jax.vjp`` of the
reference's XLA path (``repro.models.common.blockwise_attention``,
``repro.kernels.ref.ssd_chunked_ref``) on the same bf16 values taken as
f32: within 2e-2 of the scale, the bf16 kernels' tolerance on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK
from repro.models import common as RC
from repro_torch.kernels import ref, ssd_scan
from repro_torch.kernels.flash_attention import flash_attention_plain

F32_TOL = 1e-5      # of each gradient's scale: the model without rounding
BF16_TOL = 2e-2     # ... with bf16 inputs, against the reference


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


def _bf16_values(*arrays):
    """Each array rounded to bf16, as numpy f32 (what both sides see)."""
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]


# (B, Hq, Hkv, Sq, Sk, Dh, causal, window): causal rep 1; a window across
# the kernels' 64-row tiles at rep 4; Dh 128 over a ragged Sk; causal with
# Sq > Sk (rows with no valid key) at rep 8; non-causal with Sq < Sk
ATTN_CASES = [
    (2, 4, 4, 96, 96, 64, True, None),
    (1, 8, 2, 130, 130, 64, True, 40),
    (1, 4, 1, 70, 77, 128, True, None),
    (1, 8, 1, 90, 60, 64, True, None),
    (2, 4, 2, 40, 100, 128, False, None),
]
ATTN_IDS = ["causal-rep1", "window-rep4", "dh128-ragged", "sq>sk-rep8", "full-sq<sk-dh128"]


def _attn(case, seed=0):
    b, hq, hkv, sq, sk, dh, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=s).astype(np.float32)
                     for s in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh),
                               (b, hq, sq, dh)))
    return (q, k, v, dout), causal, window


@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_flash_mma_model_without_rounding_is_the_closed_form(case):
    arrays, causal, window = _attn(case)
    q, k, v, dout = map(torch.from_numpy, arrays)
    out = flash_attention_plain(q, k, v, causal, window)
    lse = ref.attention_lse_ref(q, k, causal, window)
    got = ref.flash_attention_bwd_mma_ref(q, k, v, out, dout, lse, causal, window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal, window)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        _close_to_scale(g.numpy(), w.numpy(), F32_TOL, f"d{name}")


@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_flash_mma_model_bf16_matches_jax(case):
    arrays, causal, window = _attn(case, seed=1)
    arrays = _bf16_values(*arrays)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in arrays)
    out = flash_attention_plain(q, k, v, causal, window)
    lse = ref.attention_lse_ref(q, k, causal, window)
    got = ref.flash_attention_bwd_mma_ref(q, k, v, out, dout, lse, causal, window)
    sk = k.shape[2]

    def fwd(q, k, v):
        return RC.blockwise_attention(q, k, v, causal=causal, window=window,
                                      block_k=min(512, sk))
    _, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in arrays[:3]))
    for name, g, w in zip("qkv", got, vjp(jnp.asarray(arrays[3]))):
        assert g.dtype == torch.bfloat16
        _close_to_scale(g.float().numpy(), np.asarray(w), BF16_TOL, f"d{name}")


def test_flash_mma_model_rounds_p_and_ds():
    """With bf16 inputs the model is not the closed form on the same
    values: it rounds p and ds before their products, as the kernels."""
    arrays, causal, window = _attn(ATTN_CASES[0], seed=2)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in arrays)
    out = flash_attention_plain(q, k, v, causal, window)
    lse = ref.attention_lse_ref(q, k, causal, window)
    got = ref.flash_attention_bwd_mma_ref(q, k, v, out, dout, lse, causal, window)
    exact = ref.flash_attention_bwd_mma_ref(*(t.float() for t in (q, k, v, out, dout)), lse,
                                            causal, window)
    for g, e in zip(got, exact):
        assert not torch.equal(g.float(), e.bfloat16().float())
        _close_to_scale(g.float().numpy(), e.numpy(), 1e-2)


def _ssd(case, seed=0):
    b, s, h, p, n, dt_hi, a_hi = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, dt_hi, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 0.5 + a_hi, size=h).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    d = rng.normal(size=h).astype(np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    return [x, dt, a, bm, cm, d, dy]


# (B, S, H, P, N, dt range, a range): two chunks of 64; mamba2's N=128 over
# a ragged S (a padded last chunk); the clip at -60 active within chunks;
# S shorter than one chunk
SSD_CASES = [
    (2, 128, 3, 16, 8, 0.2, 1.5),
    (1, 100, 2, 8, 128, 0.2, 1.5),
    (2, 128, 2, 8, 6, 1.0, 4.0),
    (2, 40, 3, 6, 4, 0.2, 1.5),
]
SSD_IDS = ["two-chunks", "n128-ragged-s", "clip-active", "one-short-chunk"]
SSD_NAMES = ("x", "dt", "a", "b", "c", "d")


@pytest.mark.parametrize("case", [c for c in SSD_CASES if c[5] < 1.0],
                         ids=[i for c, i in zip(SSD_CASES, SSD_IDS) if c[5] < 1.0])
def test_ssd_mma_model_without_rounding_is_the_closed_form(case):
    args = [torch.from_numpy(t) for t in _ssd(case)]
    got = ref.ssd_scan_bwd_mma_ref(*args)
    want = ref.ssd_scan_bwd_ref(*args)
    for name, g, w in zip(SSD_NAMES, got, want):
        assert g.dtype == torch.float32
        _close_to_scale(g.numpy(), w.numpy(), F32_TOL, f"d{name}")


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_mma_model_is_the_closed_form_in_f64(case):
    """The decomposition itself (states carried forward and back, base-2
    exponents and their clip masks, the chunk's gradients), free of f32
    rounding: where the clip is active ``da`` cancels to a small share of
    its terms, and two f32 evaluations of the same closed form in another
    order (this model's and ``ssd_scan_bwd_ref``'s) each sit 1e-5 to 2e-5
    of its scale from the f64 one."""
    args = [torch.from_numpy(t).double() for t in _ssd(case, seed=1)]
    got = ref.ssd_scan_bwd_mma_ref(*args)
    want = ref.ssd_scan_bwd_ref(*args)
    for name, g, w in zip(SSD_NAMES, got, want):
        assert g.dtype == torch.float64
        _close_to_scale(g.numpy(), w.numpy(), F32_TOL, f"d{name}")


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_mma_model_bf16_matches_jax(case):
    arrays = _ssd(case, seed=2)
    for i in (0, 3, 4, 6):       # x, b, c and dy are bf16 in the kernel
        arrays[i] = _bf16_values(arrays[i])[0]
    args = [torch.from_numpy(t) for t in arrays]
    for i in (0, 3, 4, 6):
        args[i] = args[i].bfloat16()
    got = ref.ssd_scan_bwd_mma_ref(*args)
    s = case[1]
    if s % 64 == 0:
        fwd = lambda *a: RK.ssd_chunked_ref(*a, chunk=64)  # noqa: E731
    elif s < 64:
        fwd = lambda *a: RK.ssd_chunked_ref(*a, chunk=s)  # noqa: E731
    else:
        fwd = RK.ssd_scan_ref
    _, vjp = jax.vjp(fwd, *(jnp.asarray(t) for t in arrays[:6]))
    for name, g, w, t in zip(SSD_NAMES, got, vjp(jnp.asarray(arrays[6])), args):
        assert g.dtype == t.dtype
        _close_to_scale(g.float().numpy(), np.asarray(w), BF16_TOL, f"d{name}")


def test_ssd_mma_model_rounds_where_the_kernels_round():
    """With bf16 inputs the model is not its own arithmetic on the same
    values in f32: it rounds the state operands, H, R and the weighted
    factors before their products."""
    arrays = _ssd(SSD_CASES[0], seed=3)
    for i in (0, 3, 4, 6):
        arrays[i] = _bf16_values(arrays[i])[0]
    exact = ref.ssd_scan_bwd_mma_ref(*map(torch.from_numpy, arrays))
    args = [torch.from_numpy(t) for t in arrays]
    for i in (0, 3, 4, 6):
        args[i] = args[i].bfloat16()
    got = ref.ssd_scan_bwd_mma_ref(*args)
    for name in ("x", "b", "c"):
        i = SSD_NAMES.index(name)
        assert not torch.equal(got[i].float(), exact[i].to(torch.bfloat16).float()), name
    for g, e in zip(got, exact):
        _close_to_scale(g.float().numpy(), e.numpy(), 1e-2)


def test_ssd_bwd_shared_memory_guards_count_what_the_launchers_ask():
    """``bwd_smem_bytes`` (f32) is the f32 launcher's request: x, dy, b, c,
    the state and its gradient, three chunk-square matrices and eight
    vectors, 151,808 bytes at zamba2's N = P = 64; ``bwd_mma_smem_bytes``
    (bf16) the larger of the states and chunk blocks' layouts.  A shape
    one step past a block's 232,448 bytes is refused."""
    assert ssd_scan.bwd_smem_bytes(64, 64) == 151_808
    assert ssd_scan.bwd_smem_bytes(64, 142) <= ssd_scan.SMEM_OPTIN < \
        ssd_scan.bwd_smem_bytes(64, 143)
    # the chunk block: x, dy, b, c, H, R, G∘L, dM∘L as bf16 [64][72] tiles,
    # and 14 f32 vectors of 64
    assert ssd_scan.bwd_mma_smem_bytes(64, 64) == 8 * 64 * 72 * 2 + 14 * 64 * 4 == 77_312
    assert ssd_scan.bwd_mma_smem_bytes(128, 64) == 112_128
    # P=8 is one k slice of 16 (rows of 24): 2 (2·64·24 + 2·64·72 + 2·64·24 +
    # 2·64·72) + 14·64·4, still above the states block's 38,400
    assert ssd_scan.bwd_mma_smem_bytes(64, 8) == 52_736
    assert ssd_scan.bwd_mma_smem_bytes(128, 208) <= ssd_scan.SMEM_OPTIN < \
        ssd_scan.bwd_mma_smem_bytes(128, 216)

"""RoPE in the port (``kernels.ops.rope``) on the CPU: the plain version
``kernels.ref.rope_ref`` against the former chain (:func:`apply_rope`) bit for bit,
the kernel's frequency table against the former expression, the autograd Function's
backward against autograd through the chain, the meta path, the attention
layers against their former formulation bit for bit, and where the models
call it.  The CUDA kernel itself is held against ``rope_ref`` on the card
by ``chip_smoke.py`` (``rope_checks``)."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ref import rope_freqs
from repro_torch.kernels.rope import freq_table, rope_cuda
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.attention import attn_apply, attn_decode, attn_init
from repro_torch.models.common import wide

THETAS = (1e4, 5e5, 5e6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(b, h, s, dh, dtype, view, seed=0):
    """[B, H, S, Dh]: the projection's transposed view of [B, S, H, Dh], or
    a contiguous tensor."""
    gen = torch.Generator().manual_seed(seed)
    base = torch.randn(b, s, h, dh, generator=gen, dtype=torch.float64).to(dtype)
    x = base.transpose(1, 2)
    return x if view else x.contiguous()


@pytest.mark.parametrize("view", [True, False], ids=["view", "contiguous"])
@pytest.mark.parametrize("s", [1, 64])
@pytest.mark.parametrize("pos0", [0, 4095])
@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64],
                         ids=["bf16", "f32", "f64"])
def test_rope_ref_is_apply_rope_bit_for_bit(dtype, dh, theta, pos0, s, view):
    x = _x(2, 3, s, dh, dtype, view)
    got = ref.rope_ref(x, pos0, theta)
    want = apply_rope(x, torch.arange(pos0, pos0 + s), theta)
    assert got.dtype == x.dtype and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("dh", [6, 64, 72, 128, 256])
def test_freq_table_holds_the_former_frequencies_bit_for_bit(dh, theta):
    """The kernel's table (``rope_freqs``, ``theta`` filled on the device)
    holds the frequencies of the former expression (``theta`` copied from
    the host), and is built once."""
    table = freq_table(dh, theta, torch.device("cpu"))
    exps = -torch.arange(0, dh, 2, dtype=torch.float32) / dh
    assert table.dtype == torch.float32 and table.shape == (dh // 2,)
    assert torch.equal(table, torch.pow(torch.tensor(theta, dtype=torch.float32), exps))
    assert torch.equal(table, rope_freqs(dh, theta, "cpu"))
    assert freq_table(dh, theta, torch.device("cpu")) is table


@pytest.mark.parametrize("pos0", [0, 4095])
@pytest.mark.parametrize("view", [True, False], ids=["view", "contiguous"])
def test_function_backward_matches_autograd_through_the_chain(view, pos0):
    """Under grad ``ops.rope`` takes the Function, whose CPU backward (the
    rotation by the negated angles) gives autograd's gradient through the
    old chain within 1e-5 relative in f32; its forward is the no-grad
    path's, bit for bit."""
    x = _x(2, 4, 48, 64, torch.float32, view).requires_grad_(True)
    w = torch.randn(2, 4, 48, 64, generator=torch.Generator().manual_seed(1))
    y = ops.rope(x, pos0, 5e5)
    assert type(y.grad_fn).__name__ == "RopeBackward"
    (y * w).sum().backward()
    x_old = x.detach().clone().requires_grad_(True)
    y_old = apply_rope(x_old, torch.arange(pos0, pos0 + 48), 5e5)
    (y_old * w).sum().backward()
    assert torch.equal(y.detach(), y_old.detach())
    torch.testing.assert_close(x.grad, x_old.grad, rtol=1e-5, atol=1e-5 * x_old.grad.abs().max())


def test_meta_returns_the_plain_versions_shape_and_dtype():
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.empty(2, 8, 5, 64, 4, dtype=dtype, device="meta")[..., 0]   # strided
        got, want = ops.rope(x, 3, 1e4), ref.rope_ref(x, 3, 1e4)
        assert got.device.type == "meta"
        assert (got.shape, got.dtype, got.stride()) == (want.shape, want.dtype, want.stride())


def test_cpu_dispatch_launches_nothing_and_the_wrapper_refuses_cpu_tensors():
    before = dict(_build.LAUNCHES)
    x = _x(1, 2, 8, 64, torch.float32, True)
    ops.rope(x, 0, 1e4)
    ops.rope(x.clone().requires_grad_(True), 0, 1e4).sum().backward()
    with pytest.raises(ValueError, match="CUDA"):
        rope_cuda(x, 0, 1e4)
    assert _build.LAUNCHES == before


def apply_rope(x, positions, theta: float = 10_000.0):
    """The former ``models.common.apply_rope``, the attention layers' chain
    before the kernel.  x: [..., S, Dh]; positions: broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # [Dh/2]
    angles = positions[..., None].float() * freqs                   # [..., S, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = wide(x).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _old_rope(x, pos0, theta):
    """The attention layers' former RoPE: ``apply_rope`` over positions
    ``[1, 1, S]`` (``arange`` in prefill, ``full`` at the position in
    decode)."""
    return apply_rope(x, torch.arange(pos0, pos0 + x.shape[-2])[None, None, :], theta)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "olmo-1b"])
def test_attention_gives_the_former_formulations_bits(arch, dtype, monkeypatch):
    """``attn_apply`` (prefill) and ``attn_decode`` at position 37 of a
    64-slot cache: output and cache through ``ops.rope`` equal bit for bit
    those through the former ``apply_rope`` calls."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    wt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    p = attn_init(gen, cfg)
    x = torch.randn(2, 40, cfg.d_model, generator=gen).to(wt)
    x1 = torch.randn(2, 1, cfg.d_model, generator=gen).to(wt)
    shape = (2, cfg.physical_kv_heads, 64, cfg.head_dim)
    cache0 = {"k": torch.randn(shape, generator=gen).to(wt),
              "v": torch.randn(shape, generator=gen).to(wt)}

    def run():
        out, (k, v) = attn_apply(p, cfg, x)
        cache = {name: t.clone() for name, t in cache0.items()}
        out1, _ = attn_decode(p, cfg, x1, cache, 37)
        return out, k, v, out1, cache["k"], cache["v"]

    new = run()
    monkeypatch.setattr(ops, "rope", _old_rope)
    old = run()
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch, per_layer", [("granite-3-2b", 2), ("granite-4.0-h-small", 0)])
def test_rope_calls_in_a_prefill(arch, per_layer, monkeypatch):
    """Twice a layer (q and k) in a granite-3-2b prefill; never in
    granite-4.0-h-small's, whose attention layers are NoPE."""
    cfg = get_config(arch).reduced()
    calls = []
    real = ops.rope

    def counting(x, pos0, theta):
        calls.append((tuple(x.shape), pos0))
        return real(x, pos0, theta)

    monkeypatch.setattr(ops, "rope", counting)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        prefill(params, cfg, tokens, 32)
    assert len(calls) == per_layer * cfg.num_layers
    assert all(pos0 == 0 for _, pos0 in calls)
    if per_layer:
        heads = [shape[1] for shape, _ in calls]
        assert heads == [cfg.physical_heads, cfg.physical_kv_heads] * cfg.num_layers


def test_decode_step_rotates_at_the_position(monkeypatch):
    """In a decode step each layer rotates q and the new key at the cache's
    position, one row each."""
    cfg = get_config("granite-3-2b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, caches = prefill(params, cfg, tokens, 32)
        calls = []
        real = ops.rope
        monkeypatch.setattr(ops, "rope", lambda x, pos0, theta: calls.append(
            (x.shape[2], pos0)) or real(x, pos0, theta))
        decode_step(params, cfg, tokens[:, -1], caches)
    assert calls == [(1, 16)] * (2 * cfg.num_layers)

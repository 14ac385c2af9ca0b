"""granite-4.0-h-small in the port, on the CPU at its reduced size in f32:
the registry resolves the port-only name and leaves the reference's ten
ids alone; the dropless MoE computes every assignment (against the
every-expert oracle ``moe_apply_dense_ref``, also at a load under which
the capacity path drops); the expert products' plain version against a
per-row loop; the attention kernels' plain versions at a softmax scale
other than ``Dh ** -0.5``; and ``prefill`` followed by ``decode_step``
against the full forward, with the cache holding Mamba states and K/V.

The plain f32 reference of the benchmark holds the same model in
``perfbench/test_perfbench_hybrid.py``."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCH_IDS, CLI_ALIASES, PORT_ONLY, all_configs, get_config
from repro_torch.configs.granite_4_0_h_small import CONFIG, PATTERN, GraniteHybridConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import (moe_apply, moe_apply_dense_ref, moe_apply_dropless,
                                    moe_dispatch, moe_init, moe_route, moe_capacity)

#: f32 on both sides, one function summed in another order (the plain
#: attention over key blocks, the SSD in chunks, the closed-form final
#: state, the MoE's grouped combine): rounding alone, measured below 2e-6
#: of the scale; 1e-5 leaves room for other BLAS builds and threads
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def scale_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def reduced():
    return get_config("granite-4.0-h-small").reduced()


def test_registry_resolves_the_port_only_name():
    assert get_config("granite-4.0-h-small") is CONFIG
    assert get_config("granite_4_0_h_small") is CONFIG
    assert PORT_ONLY == {"granite-4.0-h-small": "granite_4_0_h_small"}
    assert "granite_4_0_h_small" not in ARCH_IDS and "granite-4.0-h-small" not in CLI_ALIASES
    assert len(ARCH_IDS) == len(CLI_ALIASES) == 10 and list(all_configs()) == ARCH_IDS


def test_config_extends_arch_config_without_new_fields():
    base = {f.name for f in dataclasses.fields(ArchConfig)}
    own = {f.name for f in dataclasses.fields(GraniteHybridConfig)} - base
    assert isinstance(CONFIG, ArchConfig) and "layer_pattern" not in base
    assert own == {"layer_pattern", "shared_d_ff", "embedding_multiplier", "residual_multiplier",
                   "attention_multiplier", "logits_scaling", "position_embedding_type",
                   "tie_word_embeddings", "rms_norm_eps"}


def test_config_has_the_published_widths():
    c = CONFIG
    assert PATTERN == "MMMMMA" + "MMMMMMMMMA" * 3 + "MMMM"
    assert [i for i, k in enumerate(c.layer_pattern) if k == "A"] == [5, 15, 25, 35]
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.head_dim) == \
        (40, 4096, 32, 8, 128)
    assert (c.num_experts, c.experts_per_token, c.d_ff, c.shared_d_ff) == (72, 10, 768, 1536)
    assert (c.ssm_state, c.ssm_head_dim, c.ssm_heads, c.d_inner, c.conv_kernel) == \
        (128, 64, 128, 8192, 4)
    assert (c.vocab_size, c.physical_vocab, c.dtype) == (100352, 100352, "bfloat16")
    assert (c.embedding_multiplier, c.residual_multiplier, c.attention_multiplier,
            c.logits_scaling, c.rms_norm_eps) == (12.0, 0.22, 1 / 128, 16.0, 1e-5)
    assert c.position_embedding_type == "nope" and c.tie_word_embeddings


def test_reduced_keeps_both_mixers_the_experts_and_the_shared_expert():
    r = reduced()
    assert set(r.layer_pattern) == {"M", "A"} and len(r.layer_pattern) == r.num_layers
    assert r.num_experts >= 4 and r.experts_per_token >= 2 and r.shared_d_ff > 0
    assert r.dtype == "float32" and r.attention_multiplier == CONFIG.attention_multiplier


def test_the_block_program_refuses_what_the_port_does_not_run():
    from repro_torch.models.transformer import build_program

    cfg = reduced()
    assert build_program(cfg) == [("granite_hybrid", 3)]
    for bad in (dict(tie_word_embeddings=False), dict(layer_pattern="MAX"),
                dict(layer_pattern="MA")):
        with pytest.raises(ValueError):
            build_program(dataclasses.replace(cfg, **bad))


def test_params_are_tied_and_stacked_by_mixer():
    cfg = reduced()
    p = init_params(torch.Generator().manual_seed(0), cfg, device="meta")
    g = p["groups"]["granite_hybrid"]
    assert "head" not in p
    assert g["mamba"]["w_in"].shape[0] == cfg.layer_pattern.count("M")
    assert g["attn"]["wq"].shape[0] == cfg.layer_pattern.count("A")
    assert g["moe"]["w_gate"].shape == (cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert g["shared"]["w_down"].shape == (cfg.num_layers, cfg.shared_d_ff, cfg.d_model)
    assert g["ln1"].shape == g["ln2"].shape == (cfg.num_layers, cfg.d_model)


def _moe(seed: int, t: int, skew: float = 0.0):
    """The reduced MoE's params and tokens [t, d]; ``skew`` adds a direction
    shared by every token that the router's first expert follows, so
    that expert takes every token."""
    cfg = reduced()
    gen = torch.Generator().manual_seed(seed)
    params = moe_init(gen, cfg, device="cpu")
    x = torch.randn(t, cfg.d_model, generator=gen)
    if skew:
        u = torch.randn(cfg.d_model, generator=gen)
        x = x + skew * u
        params["router"][:, 0] = u / u.norm()
    return cfg, params, x


@pytest.mark.parametrize("seed,t", [(0, 1), (1, 7), (2, 64), (3, 257)])
def test_dropless_moe_matches_every_expert_oracle(seed, t):
    cfg, params, x = _moe(seed, t)
    y, aux = moe_apply_dropless(params, cfg, x)
    assert scale_err(y, moe_apply_dense_ref(params, cfg, x)) < TOL
    _, aux_cap = moe_apply(params, cfg, x)
    assert torch.allclose(aux, aux_cap)


def test_dropless_moe_drops_nothing_where_capacity_drops():
    """At a load skewed onto one expert the capacity path (factor 1.25)
    drops assignments and so departs from the oracle; the dropless path
    does not."""
    cfg, params, x = _moe(4, 96, skew=6.0)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    _, _, idx = moe_route(params, x, cfg.experts_per_token)
    assert bool((idx == 0).any(-1).all())                  # every token to expert 0
    _, slot = moe_dispatch(idx, cfg.num_experts, moe_capacity(cfg, x.shape[0]))
    assert int((slot == cfg.num_experts * moe_capacity(cfg, x.shape[0])).sum()) > 0
    want = moe_apply_dense_ref(params, cfg, x)
    assert scale_err(moe_apply_dropless(params, cfg, x)[0], want) < TOL
    assert scale_err(moe_apply(params, cfg, x)[0], want) > 1e-2


@pytest.mark.parametrize("counts", [[3, 0, 5, 1], [0, 0, 9, 0], [0, 0, 0, 0], [2, 2, 2, 2]])
def test_moe_experts_plain_version_is_each_rows_expert(counts):
    gen = torch.Generator().manual_seed(len(counts) + sum(counts))
    e, d, f = len(counts), 16, 24
    xs = torch.randn(sum(counts), d, generator=gen)
    wg, wu = torch.randn(e, d, f, generator=gen), torch.randn(e, d, f, generator=gen)
    wd = torch.randn(e, f, d, generator=gen)
    ends = torch.cumsum(torch.tensor(counts), 0).to(torch.int32)
    got = ops.moe_experts(xs, ends, wg, wu, wd)
    owner = torch.repeat_interleave(torch.arange(e), torch.tensor(counts))
    want = torch.stack([(torch.nn.functional.silu(r @ wg[o]) * (r @ wu[o])) @ wd[o]
                        for r, o in zip(xs, owner)]) if len(owner) else xs.new_zeros((0, d))
    assert got.shape == (sum(counts), d)
    if len(owner):
        assert scale_err(got, want) < TOL


@pytest.mark.parametrize("scale", [1 / 128, 0.3])
def test_attention_plain_versions_take_a_scale(scale):
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(2, 4, 40, 64, generator=gen)
    k, v = torch.randn(2, 2, 40, 64, generator=gen), torch.randn(2, 2, 40, 64, generator=gen)
    got = ops.flash_attention(q, k, v, causal=True, scale=scale)
    assert scale_err(got, ref.mha_ref(q, k, v, causal=True, scale=scale)) < TOL
    kv_len = torch.tensor([40, 17], dtype=torch.int32)
    dec = ops.gqa_decode(q[:, :, -1], k, v, kv_len=kv_len, scale=scale)
    want = torch.stack([ref.mha_ref(q[i:i + 1, :, -1:], k[i:i + 1, :, :n], v[i:i + 1, :, :n],
                                    causal=False, scale=scale)[:, :, 0]
                        for i, n in enumerate(kv_len.tolist())]).squeeze(1)
    assert scale_err(dec, want) < TOL


def test_attention_gradient_takes_the_scale():
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(1, 2, 24, 64, generator=gen, requires_grad=True) for _ in range(3))
    ops.flash_attention(q, k, v, scale=1 / 128).square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ref.mha_ref(q, k, v, causal=True, scale=1 / 128).square().sum().backward()
    for g, t in zip(got, (q, k, v)):
        assert scale_err(g, t.grad) < 1e-4


def _tokens(cfg, b: int, s: int, seed: int = 0):
    return torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(seed))


def test_cache_holds_mamba_states_and_attention_kv():
    cfg = reduced()
    c = init_cache(cfg, 2, 48, device="cpu")["granite_hybrid"]
    n_m, n_a = cfg.layer_pattern.count("M"), cfg.layer_pattern.count("A")
    assert c["mamba"]["ssm"].shape == (n_m, 2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    assert c["mamba"]["conv"].shape == (n_m, 2, cfg.conv_kernel - 1,
                                        cfg.d_inner + 2 * cfg.ssm_state)
    assert c["attn"]["k"].shape == (n_a, 2, cfg.num_kv_heads, 48, cfg.head_dim)


@pytest.mark.parametrize("prompt,steps", [(1, 6), (20, 5), (64, 8)])
def test_prefill_then_decode_matches_forward(prompt, steps):
    cfg = reduced()
    params = init_params(torch.Generator().manual_seed(prompt), cfg, device="cpu")
    toks = _tokens(cfg, 2, prompt + steps, seed=prompt)
    with torch.no_grad():
        full, _, _ = forward(params, cfg, toks)
        logits, cache = prefill(params, cfg, toks[:, :prompt], prompt + steps)
        assert scale_err(logits, full[:, prompt - 1]) < TOL
        assert cache["pos"] == prompt
        for t in range(prompt, prompt + steps):
            logits, cache = decode_step(params, cfg, toks[:, t], cache)
            assert scale_err(logits, full[:, t]) < TOL
    assert cache["pos"] == prompt + steps


def test_nope_differs_from_rope():
    """The attention layers take no positional embedding: the keys a
    prefill caches, and its logits, differ from those the same weights
    give with RoPE (position 0 alone is unrotated)."""
    cfg = reduced()
    params = init_params(torch.Generator().manual_seed(9), cfg, device="cpu")
    toks = _tokens(cfg, 1, 32, seed=9)
    with torch.no_grad():
        nope, c_nope = prefill(params, cfg, toks, 32)
        rope, c_rope = prefill(params, dataclasses.replace(cfg, position_embedding_type="rope"),
                               toks, 32)
    k_nope, k_rope = (c["granite_hybrid"]["attn"]["k"] for c in (c_nope, c_rope))
    assert torch.equal(k_nope[..., 0, :], k_rope[..., 0, :])
    assert scale_err(k_rope, k_nope) > 0.1
    assert not torch.equal(nope, rope)

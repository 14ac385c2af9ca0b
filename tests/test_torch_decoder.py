"""The port's ``decoder`` group (dense and MoE: ``repro_torch.models``'
transformer with ``models.moe``) against the reference with the same
parameters, which cross from ``repro.models``' ``init_params`` through
numpy and ``repro_torch.params.from_numpy``.

Configurations: the six decoder configurations' ``reduced()`` variants, all
f32 (granite-3-2b, olmo-1b with its non-parametric LayerNorm, qwen1.5-32b
with QKV biases drawn non-zero in both trees, yi-34b, phi3.5-moe,
mixtral-8x22b with its window cut to 64).  The port runs its CPU path, the
reference its XLA path.  Tolerances, those of ``tests/test_torch_zoo.py``:
the forward's logits 1e-4 of their scale, prefill and decode logits 1e-4
absolute, the MoE balance loss 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as RC
from repro.models import transformer as RT
from repro.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch import params as P
from repro_torch.configs import CLI_ALIASES, all_configs, get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import common as TC
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models import transformer as TT
from repro_torch.models.config import ArchConfig

MODEL = dict(atol=1e-4, rtol=1e-4)
AUX = 1e-6
ARCHS = ["granite-3-2b", "olmo-1b", "qwen1.5-32b", "yi-34b", "phi3.5-moe-42b-a6.6b",
         "mixtral-8x22b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(ref_cfg):
    return ArchConfig(**dataclasses.asdict(ref_cfg))


def _np(x):
    return np.asarray(x, np.float32)


def _close_to_scale(got, want, atol):
    got, want = np.asarray(got, np.float32), _np(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _with_biases(params, seed):
    """``params`` with every attention bias drawn from a seeded normal (the
    reference initialises them to zeros, which would hide a dropped bias)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(0.5 * rng.normal(size=v.shape), v.dtype)
                        if k in ("bq", "bk", "bv") else walk(v)) for k, v in node.items()}
        return node
    return walk(params)


def _trees(ref_cfg, seed=0):
    params = RT.init_params(jax.random.PRNGKey(seed), ref_cfg)
    if ref_cfg.qkv_bias:
        params = _with_biases(params, seed + 100)
    return params, P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    ref_cfg = ref_get_config(request.param).reduced()
    params, tparams = _trees(ref_cfg)
    return ref_cfg, params, _port_cfg(ref_cfg), tparams


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_and_is_a_decoder(arch):
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(arch))
    assert RT.build_program(ref_get_config(arch)) == [("decoder", cfg.num_layers)]


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "seamless-m4t-medium"])
def test_unported_configs_still_raise(arch):
    """The last two zoo ids, once refused, are now the reference's: the
    config, its block program, and its entry in ``all_configs()``."""
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(arch))
    assert RT.build_program(ref_get_config(arch)) == TT.build_program(cfg)
    assert dataclasses.asdict(all_configs()[CLI_ALIASES[arch]]) == dataclasses.asdict(cfg)


def test_forward_matches_reference(model):
    ref_cfg, params, cfg, tparams = model
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 64))
    want, _, waux = RT.forward(params, ref_cfg, jnp.asarray(tokens, jnp.int32))
    got, _, aux = forward(tparams, cfg, torch.from_numpy(tokens))
    assert got.shape == (2, 64, cfg.physical_vocab)
    _close_to_scale(got.numpy(), want, 1e-4)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(waux), atol=AUX, rtol=0)
    if cfg.arch_type == "moe":   # the balance loss of every layer, near 1 each
        assert 0.5 * cfg.num_layers < float(aux) < 4.0 * cfg.num_layers
    else:
        assert float(aux) == 0.0


def _cache_leaves(cache):
    return {p: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float32)
            for p, v in P.flatten_paths({k: v for k, v in cache.items() if k != "pos"})}


def _compare_caches(cache, wcache):
    leaves = _cache_leaves(cache)
    wleaves = _cache_leaves(jax.tree_util.tree_map(np.asarray, wcache))
    assert leaves.keys() == wleaves.keys()
    for path, wleaf in wleaves.items():
        scale = max(float(np.abs(wleaf).max()), 1.0)
        np.testing.assert_allclose(leaves[path] / scale, wleaf / scale, atol=1e-5,
                                   err_msg=path)


def test_prefill_and_decode_steps_match_reference(model):
    ref_cfg, params, cfg, tparams = model
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 20))
    s_pre, max_len = 16, 24
    want, wcache = RT.prefill(params, ref_cfg, jnp.asarray(tokens[:, :s_pre], jnp.int32),
                              max_len)
    got, cache = prefill(tparams, cfg, torch.from_numpy(tokens[:, :s_pre]), max_len)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    assert cache["pos"] == int(wcache["pos"]) == s_pre
    for i in range(4):
        tok = tokens[:, s_pre + i]
        want, wcache = RT.decode_step(params, ref_cfg, jnp.asarray(tok, jnp.int32), wcache)
        got, cache = decode_step(tparams, cfg, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    assert cache["pos"] == int(wcache["pos"]) == s_pre + 4
    _compare_caches(cache, wcache)


def test_port_prefill_then_decode_equals_forward(model):
    """decode_step continues where the full forward would be.  The reduced
    MoE configs' capacity factor (8) drops nothing, and decode runs at full
    capacity by design, so the two agree for MoE too."""
    _, _, cfg, tparams = model
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 15)))
    full, _, _ = forward(tparams, cfg, tokens)
    last, cache = prefill(tparams, cfg, tokens[:, :12], 24)
    np.testing.assert_allclose(last.numpy(), full[:, 11].numpy(), **MODEL)
    for i in range(3):
        lg, cache = decode_step(tparams, cfg, tokens[:, 12 + i], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, 12 + i].numpy(), **MODEL)
    assert cache["pos"] == 15


def _layout(tree):
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in P.flatten_paths(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    """Key paths, shapes and dtypes of the parameter tree and the cache,
    e.g. ``groups/decoder/attn/wq`` [L, d, Hq·Dh] and
    ``groups/decoder/moe/w_gate`` [L, E, d, f]."""
    ref_cfg = ref_get_config(arch).reduced()
    cfg = _port_cfg(ref_cfg)
    want = _layout(jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), ref_cfg)))
    got = _layout(init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    assert got == want
    if cfg.arch_type == "moe":
        assert got["groups/decoder/moe/w_gate"][0] == (cfg.num_layers, cfg.num_experts,
                                                       cfg.d_model, cfg.d_ff)
    wcache = jax.eval_shape(lambda: RT.init_cache(ref_cfg, 2, 24))
    cache = init_cache(cfg, 2, 24, device="cpu")
    assert _layout({k: v for k, v in cache.items() if k != "pos"}) == \
        _layout({k: v for k, v in wcache.items() if k != "pos"})
    assert tuple(cache["decoder"]["k"].shape) == (cfg.num_layers, 2, cfg.num_kv_heads, 24, 64)


def test_qkv_biases_are_drawn_and_change_the_output():
    """The qwen tree's biases are non-zero in both trees, and the port reads
    them: zeroing them moves the logits far beyond the tolerance."""
    ref_cfg = ref_get_config("qwen1.5-32b").reduced()
    params, tparams = _trees(ref_cfg)
    cfg = _port_cfg(ref_cfg)
    for name in ("bq", "bk", "bv"):
        assert float(np.abs(np.asarray(params["groups"]["decoder"]["attn"][name])).min()) > 0
        assert torch.equal(tparams["groups"]["decoder"]["attn"][name],
                           torch.from_numpy(np.array(params["groups"]["decoder"]["attn"][name])))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    with_b, _, _ = forward(tparams, cfg, tokens)
    zeroed = P.tree_map(lambda t: t, tparams)
    zeroed["groups"]["decoder"]["attn"] = {
        k: (torch.zeros_like(v) if k in ("bq", "bk", "bv") else v)
        for k, v in tparams["groups"]["decoder"]["attn"].items()}
    without, _, _ = forward(zeroed, cfg, tokens)
    assert float((with_b - without).abs().max()) > 1e-2 * float(with_b.abs().max())
    want, _, _ = RT.forward(params, ref_cfg, jnp.asarray(tokens.numpy(), jnp.int32))
    _close_to_scale(with_b.numpy(), want, 1e-4)


def test_layernorm_nonparametric_matches_reference():
    rng = np.random.default_rng(4)
    x = (3.0 + 2.0 * rng.normal(size=(3, 7, 256))).astype(np.float32)
    np.testing.assert_allclose(
        TC.layernorm_nonparametric(torch.from_numpy(x)).numpy(),
        _np(RC.layernorm_nonparametric(jnp.asarray(x))), atol=1e-6, rtol=0)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = TC.layernorm_nonparametric(P.from_numpy(np.asarray(xb), "cpu"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(RC.layernorm_nonparametric(xb)))


# ------------------------------------------------------------- sliding window
def _mixtral(**changes):
    ref_cfg = dataclasses.replace(ref_get_config("mixtral-8x22b").reduced(), **changes)
    assert ref_cfg.window == 64
    params, tparams = _trees(ref_cfg, seed=5)
    return ref_cfg, params, _port_cfg(ref_cfg), tparams


@pytest.mark.parametrize("attn_impl", ["blockwise", "banded"])
def test_window_forward_matches_reference_path(attn_impl):
    """S=128 over a window of 64: the port's forward (one attention path,
    the flash kernel's band) against each of the reference's paths, its
    ``attn_impl`` (``banded_attention`` for ``"banded"``)."""
    ref_cfg, params, cfg, tparams = _mixtral()
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 128))
    want, _, waux = RT.forward(params, ref_cfg, jnp.asarray(tokens, jnp.int32),
                               attn_impl=attn_impl)
    got, _, aux = forward(tparams, cfg, torch.from_numpy(tokens))
    _close_to_scale(got.numpy(), want, 1e-4)
    np.testing.assert_allclose(float(aux), float(waux), atol=AUX, rtol=0)


@pytest.mark.parametrize("ring", [False, True])
def test_window_decode_past_the_window_matches_reference(ring):
    """Prefill 56 tokens, then decode 16 past the window of 64: as published
    (the window masks the cache) and with ``ring_kv_cache`` (64 slots
    written at pos % 64, wrapping at position 64)."""
    ref_cfg, params, cfg, tparams = _mixtral(ring_kv_cache=ring)
    tokens = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 72))
    want, wcache = RT.prefill(params, ref_cfg, jnp.asarray(tokens[:, :56], jnp.int32), 80)
    got, cache = prefill(tparams, cfg, torch.from_numpy(tokens[:, :56]), 80)
    assert cache["decoder"]["k"].shape[-2] == (64 if ring else 80)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    for i in range(56, 72):
        want, wcache = RT.decode_step(params, ref_cfg, jnp.asarray(tokens[:, i], jnp.int32),
                                      wcache)
        got, cache = decode_step(tparams, cfg, torch.from_numpy(tokens[:, i]), cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    _compare_caches(cache, wcache)


def test_ring_prefill_longer_than_the_window_continues_the_forward():
    """A prompt of 100 positions into a ring of 64 (which the reference's
    prefill refuses): the ring keeps positions 36..99 at slot p % 64, and
    decode continues the windowed forward, as the published cache does."""
    _, _, cfg, tparams = _mixtral(ring_kv_cache=True)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 106)))
    full, _, _ = forward(tparams, cfg, tokens)
    last, cache = prefill(tparams, cfg, tokens[:, :100], 106)
    assert cache["decoder"]["k"].shape[-2] == 64
    np.testing.assert_allclose(last.numpy(), full[:, 99].numpy(), **MODEL)
    for i in range(100, 106):
        lg, cache = decode_step(tparams, cfg, tokens[:, i], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(), **MODEL)
    flat = dataclasses.replace(cfg, ring_kv_cache=False)
    with pytest.raises(ValueError, match="does not fit"):
        prefill(tparams, flat, tokens[:, :100], 64)


# ------------------------------------------------------------ head padding
def test_ragged_head_padding_matches_reference():
    """qwen reduced to 5 q and 5 kv heads, padded for an 8-way axis: 3 zero
    kv heads (8 is no multiple of 5) and zeroed ``w_o`` rows for the 3
    padded q heads.  The port's init has the reference's layout and zero
    pattern, and its forward on the reference's tree agrees."""
    ref_cfg = dataclasses.replace(ref_get_config("qwen1.5-32b").reduced(), num_heads=5,
                                  num_kv_heads=5).with_padding(8)
    cfg = _port_cfg(ref_cfg)
    assert (cfg.physical_heads, cfg.physical_kv_heads) == (8, 8)
    params = RT.init_params(jax.random.PRNGKey(12), ref_cfg)
    mine = init_params(torch.Generator().manual_seed(12), cfg, device="cpu")
    assert _layout(mine) == _layout(params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    for path, leaf in P.flatten_paths(np_params):
        if path.startswith("groups/decoder/attn/w"):
            ours = dict(P.flatten_paths(mine))[path].numpy()
            np.testing.assert_array_equal(ours == 0, leaf == 0, err_msg=path)
    attn = np_params["groups"]["decoder"]["attn"]
    dh = cfg.head_dim
    assert not attn["wk"].reshape(*attn["wk"].shape[:2], 8, dh)[..., 5:, :].any()
    assert not attn["wo"].reshape(cfg.num_layers, 8, dh, -1)[:, 5:].any()
    params = _with_biases(params, 13)
    tparams = P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 48))
    want, _, _ = RT.forward(params, ref_cfg, jnp.asarray(tokens, jnp.int32))
    got, _, _ = forward(tparams, cfg, torch.from_numpy(tokens))
    _close_to_scale(got.numpy(), want, 1e-4)


# ------------------------------------------------------- files and serving
def test_decoder_tree_round_trips_through_npz(tmp_path):
    """A stacked bf16 MoE decoder tree (``groups/decoder/moe/w_gate`` [L, E,
    d, f], the f32 router) from the reference's checkpoint into the port's
    ``train/checkpoint.py`` and back, bit for bit."""
    from repro_torch.train.checkpoint import load_checkpoint as port_load
    from repro_torch.train.checkpoint import save_checkpoint as port_save

    ref_cfg = dataclasses.replace(ref_get_config("phi3.5-moe-42b-a6.6b").reduced(),
                                  dtype="bfloat16")
    params = RT.init_params(jax.random.PRNGKey(1), ref_cfg)
    save_checkpoint(str(tmp_path / "ref.npz"), params, step=3)
    like = init_params(torch.Generator().manual_seed(0), _port_cfg(ref_cfg), device="cpu")
    loaded, step = port_load(str(tmp_path / "ref.npz"), like)
    assert step == 3
    moe = loaded["groups"]["decoder"]["moe"]
    assert moe["w_gate"].dtype == torch.bfloat16 and moe["router"].dtype == torch.float32
    assert tuple(moe["w_gate"].shape) == (2, 4, 256, 512)
    port_save(str(tmp_path / "port.npz"), loaded, step=4)
    back, step = load_checkpoint(str(tmp_path / "port.npz"), params)
    assert step == 4
    for (path, a), (_, b) in zip(P.flatten_paths(jax.tree_util.tree_map(np.asarray, params)),
                                 P.flatten_paths(back)):
        np.testing.assert_array_equal(np.asarray(b).view(np.uint8),
                                      np.asarray(a).view(np.uint8), err_msg=path)


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b"])
def test_serve_arch_on_the_cpu_serves_the_reduced_config(arch, capsys):
    serve_mod.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--seq", "16",
                    "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decoded 4 tokens x 2 seqs" in out
    res = serve_mod.serve(get_config(arch).reduced(), 2, 16, 4, seed=0, device="cpu")
    assert res["all_finite"] and tuple(res["token_ids"].shape) == (2, 5)
    assert int(res["token_ids"].max()) < get_config(arch).reduced().vocab_size

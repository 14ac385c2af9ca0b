"""The port's audio ``enc``/``dec`` groups (seamless-m4t-medium) against the
reference with the same parameters, which cross from ``repro.models``'
``init_params`` through numpy and ``repro_torch.params.from_numpy``.

Configuration: ``seamless-m4t-medium``'s ``reduced()`` variant in f32 (2
encoder and 2 decoder layers, d_model 256, 4/2 heads, a gelu FFN), run
with 32 frames as the reference's launcher draws them (and 100, a ragged
last key block); every ``ln*`` scale is drawn non-zero in both trees, so a
dropped norm fails.  The port runs its CPU path, the reference its XLA
path.  Tolerances: the forward's logits 1e-4 of their scale, prefill and
decode logits and every cache leaf 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import transformer as RT
from repro.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models import transformer as TT
from repro_torch.models.config import ArchConfig

ARCH = "seamless-m4t-medium"
MODEL = dict(atol=1e-4, rtol=1e-4)


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
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _drawn_scales(params, seed):
    """``params`` with every ``ln*`` scale drawn from a seeded normal (the
    reference initialises them to zero)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key.startswith("ln"):
            return jnp.asarray(0.3 * rng.normal(size=node.shape), node.dtype)
        return node
    return walk(params)


def _trees(ref_cfg, seed=0):
    params = _drawn_scales(RT.init_params(jax.random.PRNGKey(seed), ref_cfg), seed + 100)
    return params, P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _frames(cfg, b, n, seed):
    return np.random.default_rng(seed).normal(size=(b, n, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_get_config(ARCH).reduced()
    params, tparams = _trees(ref_cfg)
    return ref_cfg, params, _port_cfg(ref_cfg), tparams


def _leaves(cache):
    return {p: np.asarray(v.float().numpy() if isinstance(v, torch.Tensor) else v, np.float32)
            for p, v in P.flatten_paths({k: v for k, v in cache.items() if k != "pos"})}


def _compare_caches(cache, wcache, atol):
    leaves = _leaves(cache)
    wleaves = _leaves(jax.tree_util.tree_map(np.asarray, wcache))
    assert leaves.keys() == wleaves.keys()
    for path, wleaf in wleaves.items():
        scale = max(float(np.abs(wleaf).max()), 1.0)
        np.testing.assert_allclose(leaves[path] / scale, wleaf / scale, atol=atol,
                                   err_msg=path)


def _layout(tree):
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in P.flatten_paths(tree)}


def test_config_and_program_equal_reference():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(ARCH))
    assert RT.build_program(ref_get_config(ARCH)) == [("enc", 12), ("dec", 12)]
    assert cfg.physical_vocab == 256256


@pytest.mark.parametrize("n_frames", [32, 100])
def test_forward_matches_reference(model, n_frames):
    """The logits, and the encoder's output the forward caches as
    ``enc_memory``."""
    ref_cfg, params, cfg, tparams = model
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 40))
    frames = _frames(cfg, 2, n_frames, 16)
    want, wcaches, _ = RT.forward(params, ref_cfg, jnp.asarray(tokens, jnp.int32),
                                  {"frames": jnp.asarray(frames)}, want_cache=True)
    got, caches, aux = forward(tparams, cfg, torch.from_numpy(tokens),
                               {"frames": torch.from_numpy(frames)}, want_cache=True)
    assert got.shape == (2, 40, cfg.physical_vocab) and float(aux) == 0.0
    _close_to_scale(got.numpy(), want, 1e-4)
    assert set(caches) == set(wcaches) == {"dec", "enc_memory"}
    _close_to_scale(caches["enc_memory"].numpy(), wcaches["enc_memory"], 1e-4)


def test_encoder_is_non_causal_with_rope(model):
    """The encoder alone: a frame sees every frame (moving the last frame
    moves the first output row), and it matches the reference's
    ``_encode``."""
    ref_cfg, params, cfg, tparams = model
    frames = _frames(cfg, 2, 32, 20)
    want = RT._encode(params, ref_cfg, jnp.asarray(frames), use_remat=False)
    got = TT._encode(tparams, cfg, torch.from_numpy(frames))
    _close_to_scale(got.numpy(), want, 1e-4)
    moved = frames.copy()
    moved[:, -1] += 1.0
    assert float((TT._encode(tparams, cfg, torch.from_numpy(moved))[:, 0] - got[:, 0])
                 .abs().max()) > 1e-3


def test_prefill_and_decode_steps_match_reference(model):
    """Prefill's last logits and every cache leaf (each dec layer's self K/V
    in ``[L, B, Hkv, max_len, Dh]`` and its cross K/V over the 32 encoder
    frames), then 4 decode steps."""
    ref_cfg, params, cfg, tparams = model
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 20))
    frames = _frames(cfg, 2, 32, 17)
    s_pre, max_len = 16, 24
    want, wcache = RT.prefill(params, ref_cfg, jnp.asarray(tokens[:, :s_pre], jnp.int32),
                              max_len, {"frames": jnp.asarray(frames)})
    got, cache = prefill(tparams, cfg, torch.from_numpy(tokens[:, :s_pre]), max_len,
                         {"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    assert set(cache) == {"pos", "dec"}
    assert cache["pos"] == int(wcache["pos"]) == s_pre
    assert tuple(cache["dec"]["cross"]["k"].shape) == (2, 2, 2, 32, 64)
    _compare_caches(cache, wcache, 1e-4)
    for i in range(4):
        tok = tokens[:, s_pre + i]
        want, wcache = RT.decode_step(params, ref_cfg, jnp.asarray(tok, jnp.int32), wcache)
        got, cache = decode_step(tparams, cfg, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    assert cache["pos"] == int(wcache["pos"]) == s_pre + 4
    _compare_caches(cache, wcache, 1e-4)


def test_port_prefill_then_decode_equals_forward(model):
    """decode_step over the cross caches continues where the full forward
    over prompt + t would be."""
    _, _, cfg, tparams = model
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 15)))
    extra = {"frames": torch.from_numpy(_frames(cfg, 2, 32, 18))}
    full, _, _ = forward(tparams, cfg, tokens, extra)
    last, cache = prefill(tparams, cfg, tokens[:, :12], 24, extra)
    np.testing.assert_allclose(last.numpy(), full[:, 11].numpy(), **MODEL)
    for i in range(3):
        lg, cache = decode_step(tparams, cfg, tokens[:, 12 + i], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, 12 + i].numpy(), **MODEL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_layout_match_reference(dtype):
    """Key paths, shapes and dtypes of the parameter tree and of the cache,
    with the default memory length (1,024) and the launcher's 32."""
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), dtype=dtype)
    cfg = _port_cfg(ref_cfg)
    want = _layout(jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), ref_cfg)))
    got = _layout(init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    assert got == want
    assert got["groups/dec/cross/wk"] == ((2, 256, 128), dtype)
    for extra_shapes in (None, {"memory_len": 32}):
        wcache = jax.eval_shape(lambda: RT.init_cache(ref_cfg, 2, 24, extra_shapes))
        cache = init_cache(cfg, 2, 24, extra_shapes, device="cpu")
        assert _layout({k: v for k, v in cache.items() if k != "pos"}) == \
            _layout({k: v for k, v in wcache.items() if k != "pos"})
        assert cache["dec"]["cross"]["k"].shape[-2] == (extra_shapes or {}).get(
            "memory_len", 1024)


def test_bf16_frames_are_cast_on_entry():
    """A bf16 model fed f32 frames: the encoder casts them first, so the
    whole path runs in bf16; prefill within 2e-2 of the reference's
    logits' scale."""
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), dtype="bfloat16")
    cfg = _port_cfg(ref_cfg)
    params, tparams = _trees(ref_cfg, seed=3)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 16))
    frames = _frames(cfg, 2, 32, 19)
    want, _ = RT.prefill(params, ref_cfg, jnp.asarray(tokens, jnp.int32), 24,
                         {"frames": jnp.asarray(frames)})
    got, cache = prefill(tparams, cfg, torch.from_numpy(tokens), 24,
                         {"frames": torch.from_numpy(frames)})
    assert got.dtype == torch.bfloat16 and cache["dec"]["cross"]["k"].dtype == torch.bfloat16
    _close_to_scale(got.float().numpy(), want, 2e-2)


def test_audio_tree_round_trips_through_npz(tmp_path):
    """A bf16 encoder-decoder tree (``groups/enc/attn/...``,
    ``groups/dec/cross/...``) from the reference's checkpoint into the
    port's ``train/checkpoint.py`` and back, bit for bit."""
    from repro_torch.train.checkpoint import load_checkpoint as port_load
    from repro_torch.train.checkpoint import save_checkpoint as port_save

    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), dtype="bfloat16")
    params = _drawn_scales(RT.init_params(jax.random.PRNGKey(1), ref_cfg), 2)
    save_checkpoint(str(tmp_path / "ref.npz"), params, step=3)
    like = init_params(torch.Generator().manual_seed(0), _port_cfg(ref_cfg), device="cpu")
    loaded, step = port_load(str(tmp_path / "ref.npz"), like)
    assert step == 3
    assert loaded["groups"]["dec"]["cross"]["wq"].dtype == torch.bfloat16
    assert tuple(loaded["groups"]["enc"]["ffn"]["w_up"].shape) == (2, 256, 512)
    port_save(str(tmp_path / "port.npz"), loaded, step=4)
    back, step = load_checkpoint(str(tmp_path / "port.npz"), params)
    assert step == 4
    for (path, a), (_, b) in zip(P.flatten_paths(jax.tree_util.tree_map(np.asarray, params)),
                                 P.flatten_paths(back)):
        np.testing.assert_array_equal(np.asarray(b).view(np.uint8),
                                      np.asarray(a).view(np.uint8), err_msg=path)


def test_serve_inputs_equal_serve_arch(monkeypatch):
    """``serve()``'s prompts and frames are the reference launcher's for the
    same seed (read from the arguments its ``serve_arch`` hands to
    ``prefill``): 32 frames; ``frames=`` changes only their count."""
    seen = {}

    class Stop(Exception):
        pass

    def capture(params, cfg, prompts, max_len, extra=None, **kw):
        seen.update(prompts=np.asarray(prompts), **{k: np.asarray(v) for k, v in extra.items()})
        raise Stop

    monkeypatch.setattr(RT, "prefill", capture)
    args = type("Args", (), dict(arch=ARCH, seed=5, batch=3, seq=20, tokens=4))
    with pytest.raises(Stop):
        ref_serve.serve_arch(args)
    cfg = get_config(ARCH).reduced()
    prompts, extra = serve_mod.serve_inputs(cfg, 3, 20, seed=5, device="cpu")
    assert set(extra) == {"frames"} and tuple(extra["frames"].shape) == (3, 32, cfg.d_model)
    np.testing.assert_array_equal(prompts.numpy(), seen["prompts"])
    np.testing.assert_array_equal(extra["frames"].numpy(), seen["frames"])
    _, longer = serve_mod.serve_inputs(cfg, 3, 20, seed=5, frames=48, device="cpu")
    assert tuple(longer["frames"].shape) == (3, 48, cfg.d_model)


def test_serve_arch_on_the_cpu_serves_the_reduced_config(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq", "16",
                    "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decoded 4 tokens x 2 seqs" in out
    res = serve_mod.serve(get_config(ARCH).reduced(), 2, 16, 4, seed=0, device="cpu",
                          frames=40)
    assert res["all_finite"] and tuple(res["token_ids"].shape) == (2, 5)

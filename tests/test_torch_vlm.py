"""The port's ``vlm_super`` group and cross attention (llama-3.2-vision-90b)
against the reference with the same parameters, which cross from
``repro.models``' ``init_params`` through numpy and
``repro_torch.params.from_numpy``.

Configuration: ``llama-3.2-vision-90b``'s ``reduced()`` variant in f32 (2
superblocks of 4 self layers and 1 cross layer, d_model 256, 4/2 heads,
16 vision tokens); every ``ln*`` scale and every cross gate is drawn
non-zero in both trees, so a dropped norm or ``tanh`` fails.  The port runs
its CPU path, the reference its XLA path.  Tolerances: the forward's logits
1e-4 of their scale, prefill and decode logits and every cache leaf 1e-4;
a bf16 model (f32 vision embeddings, projected in f32 and rounded to bf16
for the kernel, the values the reference's decode cache holds) 2e-2 of the
logits' scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import transformer as RT
from repro.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.kernels.ref import blockwise_attention
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as TA
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.config import ArchConfig

ARCH = "llama-3.2-vision-90b"
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
    """``params`` with every ``ln*`` scale drawn from a seeded normal and
    every cross gate from [0.5, 2] (the reference initialises the scales to
    zero and the gate to 0.1, where tanh(g) ~ g)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key.startswith("ln"):
            return jnp.asarray(0.3 * rng.normal(size=node.shape), node.dtype)
        if key == "gate":
            return jnp.asarray(rng.uniform(0.5, 2.0, size=node.shape), node.dtype)
        return node
    return walk(params)


def _trees(ref_cfg, seed=0):
    params = _drawn_scales(RT.init_params(jax.random.PRNGKey(seed), ref_cfg), seed + 100)
    return params, P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _vision(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)


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
    assert RT.build_program(ref_get_config(ARCH)) == [("vlm_super", 20)]
    assert RT.build_program(ref_get_config(ARCH).reduced()) == [("vlm_super", 2)]


def test_forward_matches_reference(model):
    ref_cfg, params, cfg, tparams = model
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 48))
    vision = _vision(cfg, 2, 16)
    want, _, _ = RT.forward(params, ref_cfg, jnp.asarray(tokens, jnp.int32),
                            {"vision": jnp.asarray(vision)})
    got, _, aux = forward(tparams, cfg, torch.from_numpy(tokens),
                          {"vision": torch.from_numpy(vision)})
    assert got.shape == (2, 48, cfg.physical_vocab) and float(aux) == 0.0
    _close_to_scale(got.numpy(), want, 1e-4)


def test_prefill_and_decode_steps_match_reference(model):
    """Prefill's last logits and every cache leaf (the self layers' K/V in
    ``[n, k-1, B, Hkv, max_len, Dh]``, the cross layers' whole vision K/V in
    ``[n, B, Hkv, Tv, Dh]``), then 4 decode steps."""
    ref_cfg, params, cfg, tparams = model
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 20))
    vision = _vision(cfg, 2, 17)
    s_pre, max_len = 16, 24
    want, wcache = RT.prefill(params, ref_cfg, jnp.asarray(tokens[:, :s_pre], jnp.int32),
                              max_len, {"vision": jnp.asarray(vision)})
    got, cache = prefill(tparams, cfg, torch.from_numpy(tokens[:, :s_pre]), max_len,
                         {"vision": torch.from_numpy(vision)})
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    assert cache["pos"] == int(wcache["pos"]) == s_pre
    assert tuple(cache["vlm_super"]["cross"]["k"].shape) == (2, 2, 2, cfg.num_vision_tokens, 64)
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
    extra = {"vision": torch.from_numpy(_vision(cfg, 2, 18))}
    full, _, _ = forward(tparams, cfg, tokens, extra)
    last, cache = prefill(tparams, cfg, tokens[:, :12], 24, extra)
    np.testing.assert_allclose(last.numpy(), full[:, 11].numpy(), **MODEL)
    for i in range(3):
        lg, cache = decode_step(tparams, cfg, tokens[:, 12 + i], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, 12 + i].numpy(), **MODEL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_layout_match_reference(dtype):
    """Key paths, shapes and dtypes of the parameter tree (``gate`` f32 in a
    bf16 tree too) and of the cache, with the default vision length and
    another one."""
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), dtype=dtype)
    cfg = _port_cfg(ref_cfg)
    want = _layout(jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), ref_cfg)))
    got = _layout(init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    assert got == want
    assert got["groups/vlm_super/cross/gate"] == ((2, 1), "float32")
    assert got["groups/vlm_super/self/attn/wq"][0] == (2, 4, 256, 256)
    for extra_shapes in (None, {"vision_len": 40}):
        wcache = jax.eval_shape(lambda: RT.init_cache(ref_cfg, 2, 24, extra_shapes))
        cache = init_cache(cfg, 2, 24, extra_shapes, device="cpu")
        assert cache["pos"] == 0
        assert _layout({k: v for k, v in cache.items() if k != "pos"}) == \
            _layout({k: v for k, v in wcache.items() if k != "pos"})


def test_cross_attention_alone_matches_reference(model):
    """``attn_apply(kv_x=...)`` (no mask, RoPE on q only with ``use_rope``,
    Sk != Sq) and ``attn_decode(cross=True)`` over a static cache."""
    ref_cfg, params, cfg, tparams = model
    ap = jax.tree_util.tree_map(lambda t: t[0], params["groups"]["vlm_super"]["cross"]["attn"])
    tp = P.tree_map(lambda t: t[0], tparams["groups"]["vlm_super"]["cross"]["attn"])
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    for use_rope in (False, True):
        want, (wk, wv) = RA.attn_apply(ap, ref_cfg, jnp.asarray(x), kv_x=jnp.asarray(mem),
                                       causal=False, use_rope=use_rope)
        got, (k, v) = TA.attn_apply(tp, cfg, torch.from_numpy(x), kv_x=torch.from_numpy(mem),
                                    causal=False, use_rope=use_rope)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
        np.testing.assert_allclose(k.numpy(), _np(wk), **MODEL)
        np.testing.assert_allclose(v.numpy(), _np(wv), **MODEL)
    cache = {"k": k, "v": v}
    want, wcache = RA.attn_decode(ap, ref_cfg, jnp.asarray(x[:, :1]),
                                  {"k": wk, "v": wv}, jnp.int32(5), cross=True)
    got, out_cache = TA.attn_decode(tp, cfg, torch.from_numpy(x[:, :1]), cache, 5, cross=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    assert out_cache["k"] is k and out_cache["v"] is v


def test_plain_flash_attention_non_causal_ragged_keys_matches_reference():
    """The kernel's plain version, non-causal, Sq=512 against Sk=1,601 =
    3·512 + 65 keys (llama's vision tokens: a ragged last key block), 2
    heads at Dh 64, against the reference's ``blockwise_attention``, which
    pads and masks the tail."""
    rng = np.random.default_rng(10)
    q = rng.normal(size=(1, 2, 512, 64)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 1601, 64)).astype(np.float32) for _ in range(2))
    want = RC.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=False, block_k=512)
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=False, block_k=512)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=2e-5)


def test_bf16_vision_prefill_and_decode_match_reference():
    """A bf16 model fed f32 vision embeddings: the reference projects them in
    f32 (type promotion) and attends over f32 K/V in prefill, while its
    decode cache holds them rounded to bf16; the port projects in f32 and
    rounds once to bf16.  Prefill and 2 decode steps within 2e-2 of the
    logits' scale, the cross caches within bf16 rounding."""
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), dtype="bfloat16")
    cfg = _port_cfg(ref_cfg)
    params, tparams = _trees(ref_cfg, seed=3)
    assert tparams["groups"]["vlm_super"]["cross"]["gate"].dtype == torch.float32
    assert tparams["groups"]["vlm_super"]["cross"]["attn"]["wk"].dtype == torch.bfloat16
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 18))
    vision = _vision(cfg, 2, 19)
    want, wcache = RT.prefill(params, ref_cfg, jnp.asarray(tokens[:, :16], jnp.int32), 24,
                              {"vision": jnp.asarray(vision)})
    got, cache = prefill(tparams, cfg, torch.from_numpy(tokens[:, :16]), 24,
                         {"vision": torch.from_numpy(vision)})
    assert cache["vlm_super"]["cross"]["k"].dtype == torch.bfloat16
    _close_to_scale(got.float().numpy(), want, 2e-2)
    wcross = jax.tree_util.tree_map(np.asarray, wcache["vlm_super"]["cross"])
    _compare_caches({"x": cache["vlm_super"]["cross"]}, {"x": wcross}, 1e-2)
    for i in range(2):
        tok = tokens[:, 16 + i]
        want, wcache = RT.decode_step(params, ref_cfg, jnp.asarray(tok, jnp.int32), wcache)
        got, cache = decode_step(tparams, cfg, torch.from_numpy(tok), cache)
        _close_to_scale(got.float().numpy(), want, 2e-2)


def test_vlm_tree_round_trips_through_npz(tmp_path):
    """A bf16 vlm tree (``groups/vlm_super/self/...`` [n, k-1, ...], the f32
    gate) from the reference's checkpoint into the port's
    ``train/checkpoint.py`` and back, bit for bit."""
    from repro_torch.train.checkpoint import load_checkpoint as port_load
    from repro_torch.train.checkpoint import save_checkpoint as port_save

    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), dtype="bfloat16")
    params = _drawn_scales(RT.init_params(jax.random.PRNGKey(1), ref_cfg), 2)
    save_checkpoint(str(tmp_path / "ref.npz"), params, step=3)
    like = init_params(torch.Generator().manual_seed(0), _port_cfg(ref_cfg), device="cpu")
    loaded, step = port_load(str(tmp_path / "ref.npz"), like)
    assert step == 3
    sup = loaded["groups"]["vlm_super"]
    assert sup["cross"]["gate"].dtype == torch.float32
    assert sup["self"]["attn"]["wq"].dtype == torch.bfloat16
    assert tuple(sup["self"]["attn"]["wq"].shape) == (2, 4, 256, 256)
    port_save(str(tmp_path / "port.npz"), loaded, step=4)
    back, step = load_checkpoint(str(tmp_path / "port.npz"), params)
    assert step == 4
    for (path, a), (_, b) in zip(P.flatten_paths(jax.tree_util.tree_map(np.asarray, params)),
                                 P.flatten_paths(back)):
        np.testing.assert_array_equal(np.asarray(b).view(np.uint8),
                                      np.asarray(a).view(np.uint8), err_msg=path)


def test_serve_inputs_equal_serve_arch(monkeypatch):
    """``serve()``'s prompts and vision embeddings are the reference
    launcher's for the same seed (read from the arguments its ``serve_arch``
    hands to ``prefill``)."""
    seen = {}

    class Stop(Exception):
        pass

    def capture(params, cfg, prompts, max_len, extra=None, **kw):
        seen.update(prompts=np.asarray(prompts), max_len=max_len,
                    **{k: np.asarray(v) for k, v in (extra or {}).items()})
        raise Stop

    monkeypatch.setattr(RT, "prefill", capture)
    args = type("Args", (), dict(arch=ARCH, seed=5, batch=3, seq=20, tokens=4))
    with pytest.raises(Stop):
        ref_serve.serve_arch(args)
    prompts, extra = serve_mod.serve_inputs(get_config(ARCH).reduced(), 3, 20, seed=5,
                                            device="cpu")
    assert set(extra) == {"vision"} and extra["vision"].dtype == torch.float32
    np.testing.assert_array_equal(prompts.numpy(), seen["prompts"])
    np.testing.assert_array_equal(extra["vision"].numpy(), seen["vision"])


def test_serve_arch_on_the_cpu_serves_the_reduced_config(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq", "16",
                    "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decoded 4 tokens x 2 seqs" in out
    res = serve_mod.serve(get_config(ARCH).reduced(), 2, 16, 4, seed=0, device="cpu")
    assert res["all_finite"] and tuple(res["token_ids"].shape) == (2, 5)

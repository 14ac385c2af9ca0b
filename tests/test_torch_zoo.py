"""The port's zoo slice (``repro_torch.models``: Mamba2 blocks, the shared
attention block, the block program, prefill and decode) against the
reference with the same parameters, which cross from ``repro.models``'
``init_params`` through numpy and ``repro_torch.params.from_numpy``.

Configurations: ``zamba2-1.2b`` reduced to one superblock plus a 2-layer
``mamba`` tail (``num_layers=8``, GQA rep 2) and ``mamba2-370m`` reduced,
both f32.  The port runs its CPU path (the reference's XLA path op for op);
the reference runs with ``use_pallas=False`` and, for the forward, also
with its Pallas SSD kernel in interpret mode.  Tolerances, all f32:

* one Mamba2 block: 3e-5 of the output's scale, the reference's own
  tolerance for its SSD kernel against the sequential scan
  (``tests/test_kernels.py``): the block inherits the SSD's rounding, and
  the two frameworks sum the chunk products in other orders;
* the final SSD state: 1e-5 of its scale (a closed form in place of the
  reference's per-token scan; see ``repro_torch.models.mamba._final_state``);
* logits through the whole model: 1e-4 of their scale against the
  reference's XLA path, which the port follows op for op, and 5e-4 against
  its Pallas path, the reference's own tolerance between those two paths
  (``tests/test_integration_pallas.py``); prefill and decode logits 1e-4
  absolute, as the reference's prefill/decode consistency test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.mamba import mamba_apply as ref_mamba_apply
from repro.models.mamba import mamba_decode as ref_mamba_decode
from repro.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.config import ArchConfig
from repro_torch.models.mamba import mamba_apply, mamba_decode

BLOCK = 3e-5                  # of the block output's scale
STATE = 1e-5                  # of the SSD state's scale
MODEL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["zamba2-1.2b", "mamba2-370m"]


def _ref_cfg(arch):
    cfg = ref_get_config(arch).reduced()
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, num_layers=8)
    return cfg


def _port_cfg(ref_cfg):
    return ArchConfig(**dataclasses.asdict(ref_cfg))


def _np(x):
    return np.asarray(x, np.float32)


def _close_to_scale(got, want, atol, scale=None):
    """|got - want| <= atol * max|want| elementwise."""
    got, want = np.asarray(got, np.float32), _np(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    ref_cfg = _ref_cfg(request.param)
    params = RT.init_params(jax.random.PRNGKey(0), ref_cfg)
    tparams = P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return ref_cfg, params, _port_cfg(ref_cfg), tparams


def test_reduced_configs_are_the_reference_programs():
    assert RT.build_program(_ref_cfg("zamba2-1.2b")) == [("zamba_super", 1), ("mamba", 2)]
    assert RT.build_program(_ref_cfg("mamba2-370m")) == [("mamba", 2)]
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))


def test_other_configs_name_the_roadmap():
    """The zoo's other ids, once refused, are the reference's now; an
    unknown id still raises ``KeyError``."""
    for arch in ("llama-3.2-vision-90b", "seamless-m4t-medium"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def _mamba_layers(tree):
    """Every Mamba2 layer of a parameter tree (numpy or tensor leaves), in
    program order: the superblocks' stacks, then the ``mamba`` group."""
    groups = tree["groups"]
    layers = []
    if "zamba_super" in groups:
        sup = groups["zamba_super"]["mamba"]
        for i in range(sup["w_in"].shape[0]):
            for j in range(sup["w_in"].shape[1]):
                layers.append(P.tree_map(lambda a: a[i][j], sup))
    if "mamba" in groups:
        for i in range(groups["mamba"]["w_in"].shape[0]):
            layers.append(P.tree_map(lambda a: a[i], groups["mamba"]))
    return layers


def test_mamba_block_apply_and_decode_match_reference(model):
    """The first and the last Mamba2 layer of the model (for zamba2, one of
    a superblock and one of the tail) on their own: apply with the decode
    state, then one decode step."""
    ref_cfg, params, cfg, tparams = model
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 128, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    pairs = list(zip(_mamba_layers(np_params), _mamba_layers(tparams)))
    assert len(pairs) == cfg.num_layers
    for layer, tlayer in (pairs[0], pairs[-1]):
        want, wstate = ref_mamba_apply(layer, ref_cfg, jnp.asarray(x), return_state=True)
        got, state = mamba_apply(tlayer, cfg, torch.from_numpy(x), return_state=True)
        _close_to_scale(got.numpy(), want, BLOCK)
        np.testing.assert_allclose(state["conv"].numpy(), _np(wstate["conv"]),
                                   atol=1e-5, rtol=1e-5)
        scale = float(np.abs(_np(wstate["ssm"])).max())
        _close_to_scale(state["ssm"].numpy(), wstate["ssm"], STATE, scale)

        want1, wstate1 = ref_mamba_decode(layer, ref_cfg, jnp.asarray(x1), wstate)
        got1, state1 = mamba_decode(tlayer, cfg, torch.from_numpy(x1), state)
        _close_to_scale(got1.numpy(), want1, BLOCK)
        _close_to_scale(state1["ssm"].numpy(), wstate1["ssm"], STATE, scale)


@pytest.mark.parametrize("ffn_type", ["swiglu", "gelu"])
def test_common_blocks_match_reference(ffn_type):
    """``rmsnorm``, RoPE (``kernels.ref.rope_ref`` against ``apply_rope``)
    and ``ffn_apply`` on the reference's parameters (gelu is the tanh form,
    as ``jax.nn.gelu``)."""
    from repro.models import common as RC
    from repro_torch.kernels.ref import rope_ref
    from repro_torch.models import common as TC

    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 4, 24, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    pos = np.arange(24)[None, None, :]
    np.testing.assert_allclose(
        TC.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        _np(RC.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        rope_ref(torch.from_numpy(x), 0, 500_000.0).numpy(),
        _np(RC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)),
        atol=1e-5, rtol=1e-5)
    ffn = RC.ffn_init(jax.random.PRNGKey(3), 64, 96, ffn_type, jnp.float32)
    tffn = P.from_numpy(jax.tree_util.tree_map(np.asarray, ffn), "cpu")
    h = x.reshape(8, 24, 64)
    np.testing.assert_allclose(
        TC.ffn_apply(tffn, torch.from_numpy(h), ffn_type).numpy(),
        _np(RC.ffn_apply(ffn, jnp.asarray(h), ffn_type)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_reference(model, use_pallas):
    ref_cfg, params, cfg, tparams = model
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 128))
    want, _, _ = RT.forward(params, ref_cfg, jnp.asarray(tokens, jnp.int32),
                            use_pallas=use_pallas)
    got, _, aux = forward(tparams, cfg, torch.from_numpy(tokens))
    assert got.shape == (2, 128, cfg.physical_vocab)
    _close_to_scale(got.numpy(), want, 5e-4 if use_pallas else 1e-4)
    assert float(aux) == 0.0


def _cache_leaves(cache):
    """path -> float32 numpy array of every cache leaf but ``pos``."""
    return {p: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float32)
            for p, v in P.flatten_paths({k: v for k, v in cache.items() if k != "pos"})}


def test_prefill_and_decode_steps_match_reference(model):
    ref_cfg, params, cfg, tparams = model
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 20))
    s_pre, max_len = 16, 24
    want, wcache = RT.prefill(params, ref_cfg, jnp.asarray(tokens[:, :s_pre], jnp.int32),
                              max_len)
    got, cache = prefill(tparams, cfg, torch.from_numpy(tokens[:, :s_pre]), max_len)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    assert cache["pos"] == int(wcache["pos"]) == s_pre
    for i in range(3):
        tok = tokens[:, s_pre + i]
        want, wcache = RT.decode_step(params, ref_cfg, jnp.asarray(tok, jnp.int32), wcache)
        got, cache = decode_step(tparams, cfg, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    assert cache["pos"] == int(wcache["pos"]) == s_pre + 3
    leaves = _cache_leaves(cache)
    wleaves = _cache_leaves(jax.tree_util.tree_map(np.asarray, wcache))
    assert leaves.keys() == wleaves.keys()
    for path, wleaf in wleaves.items():
        scale = max(float(np.abs(wleaf).max()), 1.0)
        np.testing.assert_allclose(leaves[path] / scale, wleaf / scale, atol=1e-5,
                                   err_msg=path)


def test_windowed_ring_cache_decode_matches_reference():
    """A sliding window with the ring KV cache (the reference's SWA decode
    path) on the hybrid program: the window in prefill attention, decode
    writes at ``pos % window`` and wraps past the window."""
    ref_cfg = dataclasses.replace(_ref_cfg("zamba2-1.2b"), window=16, ring_kv_cache=True)
    cfg = _port_cfg(ref_cfg)
    params = RT.init_params(jax.random.PRNGKey(2), ref_cfg)
    tparams = P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 18))
    want, wcache = RT.prefill(params, ref_cfg, jnp.asarray(tokens[:, :12], jnp.int32), 24)
    got, cache = prefill(tparams, cfg, torch.from_numpy(tokens[:, :12]), 24)
    assert cache["zamba_super"]["attn"]["k"].shape[-2] == 16
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)
    for i in range(12, 18):
        want, wcache = RT.decode_step(params, ref_cfg, jnp.asarray(tokens[:, i], jnp.int32),
                                      wcache)
        got, cache = decode_step(tparams, cfg, torch.from_numpy(tokens[:, i]), cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL)


def test_port_prefill_then_decode_equals_forward(model):
    """decode_step continues exactly where the full forward would be (the
    reference's tests/test_arch_smoke.py check, on the port alone)."""
    _, _, cfg, tparams = model
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 15)))
    full, _, _ = forward(tparams, cfg, tokens)
    last, cache = prefill(tparams, cfg, tokens[:, :12], 24)
    np.testing.assert_allclose(last.numpy(), full[:, 11].numpy(), **MODEL)
    for i in range(3):
        lg, cache = decode_step(tparams, cfg, tokens[:, 12 + i], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, 12 + i].numpy(), **MODEL)
    assert cache["pos"] == 15


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    """Key paths, shapes and dtypes of the parameter tree and the cache."""
    ref_cfg = _ref_cfg(arch)
    cfg = _port_cfg(ref_cfg)

    def layout(tree):
        return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
                for p, x in P.flatten_paths(tree)}

    want = layout(jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), ref_cfg)))
    assert layout(init_params(torch.Generator().manual_seed(0), cfg, device="cpu")) == want
    wcache = jax.eval_shape(lambda: RT.init_cache(ref_cfg, 2, 24))
    cache = init_cache(cfg, 2, 24, device="cpu")
    assert cache["pos"] == 0
    assert layout({k: v for k, v in cache.items() if k != "pos"}) == \
        layout({k: v for k, v in wcache.items() if k != "pos"})


def test_init_params_is_seeded():
    cfg = _port_cfg(_ref_cfg("mamba2-370m"))
    a = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (_, x), (_, y) in zip(P.flatten_paths(a), P.flatten_paths(b)):
        assert torch.equal(x, y)


# ------------------------------------------------------- parameter files, bf16
def test_bf16_tree_round_trips_bit_for_bit():
    tree = {"w": jnp.asarray(np.random.default_rng(9).normal(size=(3, 5)), jnp.bfloat16),
            "n": [jnp.arange(4, dtype=jnp.int32), jnp.ones((2,), jnp.float32)]}
    tt = P.from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    assert tt["w"].dtype == torch.bfloat16 and tt["n"][0].dtype == torch.int32
    bits = np.asarray(tree["w"]).view(np.uint16)
    np.testing.assert_array_equal(tt["w"].view(torch.uint16).numpy(), bits)
    back = P.to_numpy(tt)
    np.testing.assert_array_equal(back["w"].view(np.uint16), bits)


def test_zoo_tree_round_trips_through_npz(tmp_path):
    """The nested, stacked bf16 tree of the zoo (``groups/zamba_super/mamba``
    with leading axes [n_super, attn_every], ``shared_attn/...``) from the
    reference's checkpoint into the port and back, bit for bit."""
    ref_cfg = dataclasses.replace(_ref_cfg("zamba2-1.2b"), dtype="bfloat16")
    params = RT.init_params(jax.random.PRNGKey(1), ref_cfg)
    save_checkpoint(str(tmp_path / "ref.npz"), params, step=2)
    loaded = P.load_npz(str(tmp_path / "ref.npz"), "cpu")
    w_in = loaded["groups"]["zamba_super"]["mamba"]["w_in"]
    assert w_in.dtype == torch.bfloat16 and w_in.shape[:2] == (1, 6)
    assert loaded["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    assert loaded["groups"]["mamba"]["a_log"].dtype == torch.float32
    P.save_npz(str(tmp_path / "port.npz"), loaded)
    back, _ = load_checkpoint(str(tmp_path / "port.npz"), params)
    for (path, a), (_, b) in zip(P.flatten_paths(jax.tree_util.tree_map(np.asarray, params)),
                                 P.flatten_paths(back)):
        np.testing.assert_array_equal(np.asarray(b).view(np.uint8),
                                      np.asarray(a).view(np.uint8), err_msg=path)

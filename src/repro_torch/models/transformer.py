"""The zoo's composable model, for the groups the port has: ``mamba`` and
``zamba_super``.

The reference's ``repro.models.transformer`` with tensors.  A config
compiles to a *block program*, an ordered list of groups, each a stack of
layers whose parameters are stacked on a leading axis (the reference's
``lax.scan`` over stacked params becomes a Python loop over that axis):

  ssm         [('mamba', L)]
  hybrid      [('zamba_super', L // k)] + [('mamba', L % k)]   (shared attn)

A ``zamba_super`` runs ``attn_every`` Mamba2 blocks and then the ONE shared
attention+MLP block, whose parameters (``shared_attn``) are shared by every
application, with one KV cache per application.  The ``decoder`` (dense and
moe), ``vlm_super`` and audio ``enc``/``dec`` groups raise
``NotImplementedError``; ``ROADMAP.md`` queue 1 holds them.  There is no
``use_pallas``: the tensors' device picks the kernel path.

Entry points: ``init_params``, ``forward``, ``prefill`` (logits + cache),
``init_cache``, ``decode_step`` (one token).  ``forward_train`` waits for
the training slice.  The decode caches are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_apply, attn_decode, attn_init
from repro_torch.models.common import dense_init, ffn_apply, ffn_init, rmsnorm, torch_dtype
from repro_torch.models.config import ArchConfig
from repro_torch.models.mamba import mamba_apply, mamba_decode, mamba_init
from repro_torch.params import tree_map
from repro_torch.utils.device import resolve_device

PORTED_GROUPS = ("mamba", "zamba_super")


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 lists the zoo's remaining "
        "groups (decoder, moe, vlm_super, enc/dec) in order")


# ---------------------------------------------------------------------------
# block program
# ---------------------------------------------------------------------------

def build_program(cfg: ArchConfig) -> list[tuple[str, int]]:
    if cfg.arch_type in ("dense", "moe"):
        return [("decoder", cfg.num_layers)]
    if cfg.arch_type == "ssm":
        return [("mamba", cfg.num_layers)]
    if cfg.arch_type == "hybrid":
        k = cfg.attn_every
        n_super, tail = divmod(cfg.num_layers, k)
        prog = [("zamba_super", n_super)]
        if tail:
            prog.append(("mamba", tail))
        return prog
    if cfg.arch_type == "vlm":
        k = cfg.cross_attn_every
        if cfg.num_layers % k:
            raise ValueError("vlm layers must tile into superblocks")
        return [("vlm_super", cfg.num_layers // k)]
    if cfg.arch_type == "audio":
        return [("enc", cfg.num_layers), ("dec", cfg.num_layers)]
    raise ValueError(cfg.arch_type)


def _ported_program(cfg: ArchConfig):
    prog = build_program(cfg)
    for gname, _ in prog:
        if gname not in PORTED_GROUPS:
            _not_ported(f"the {gname!r} group ({cfg.name}, {cfg.arch_type})")
    return prog


def _norm(cfg, x, scale):
    if cfg.nonparametric_ln:
        _not_ported("the non-parametric LayerNorm (olmo)")
    return rmsnorm(x, scale)


def _layer(stacked, i):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], stacked)


def _stack(trees):
    if not trees:
        return None
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _decoder_layer_init(gen, cfg, device=None):
    if cfg.arch_type == "moe":
        _not_ported("the moe layer (models/moe.py)")
    dtype = torch_dtype(cfg.dtype)
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "attn": attn_init(gen, cfg, device=device),
        "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_type, dtype, device=device),
    }


def _stack_init(init_fn, gen, n, cfg, device):
    return _stack([init_fn(gen, cfg, device=device) for _ in range(n)])


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Parameter tree of ``cfg`` on ``device`` (default: CUDA).

    Draws come from ``gen`` on its own device (a CUDA generator draws on the
    card, which is much faster at full width); one seed and one generator
    device give the same weights on every target device.  Key paths, shapes
    and dtypes are the reference's (``groups/zamba_super/mamba/w_in`` has
    leading axes ``[n_super, attn_every]``); the values are not.
    """
    dev = resolve_device(device)
    prog = _ported_program(cfg)
    dtype = torch_dtype(cfg.dtype)
    v = cfg.physical_vocab
    params = {
        "embed": dense_init(gen, (v, cfg.d_model), dtype, scale=0.02, device=dev),
        "head": dense_init(gen, (cfg.d_model, v), dtype, device=dev),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "groups": {},
    }
    for gname, n in prog:
        if gname == "mamba":
            params["groups"][gname] = _stack_init(mamba_init, gen, n, cfg, dev)
        else:  # zamba_super
            params["groups"][gname] = {"mamba": _stack(
                [_stack_init(mamba_init, gen, cfg.attn_every, cfg, dev)
                 for _ in range(n)])}
            params["shared_attn"] = _decoder_layer_init(gen, cfg, device=dev)
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _decoder_block(p, cfg, h, *, want_cache):
    a_out, (k, v) = attn_apply(p["attn"], cfg, _norm(cfg, h, p["ln1"]))
    h = h + a_out
    h = h + ffn_apply(p["ffn"], _norm(cfg, h, p["ln2"]), cfg.ffn_type)
    return h, ({"k": k, "v": v} if want_cache else None)


def _mamba_stack(gp, cfg, h, want_cache):
    states = []
    for i in range(gp["w_in"].shape[0]):
        y, st = mamba_apply(_layer(gp, i), cfg, rmsnorm(h), return_state=want_cache)
        h = h + y
        states.append(st)
    return h, (_stack(states) if want_cache else None)


def _run_groups(params, cfg: ArchConfig, h, *, want_cache):
    """Run the block program.  Returns (h, caches)."""
    caches = {}
    for gname, n in _ported_program(cfg):
        gp = params["groups"][gname]
        if gname == "mamba":
            h, caches[gname] = _mamba_stack(gp, cfg, h, want_cache)
        else:  # zamba_super
            shared = params["shared_attn"]
            outs = []
            for i in range(n):
                h, mstates = _mamba_stack(_layer(gp["mamba"], i), cfg, h, want_cache)
                h, acache = _decoder_block(shared, cfg, h, want_cache=want_cache)
                outs.append({"mamba": mstates, "attn": acache})
            caches[gname] = _stack(outs) if want_cache else None
    return h, (caches if want_cache else {})


def forward(params, cfg: ArchConfig, tokens, extra=None, *, want_cache=False):
    """tokens: [B, S] int.  Returns (logits [B, S, Vphys], caches, aux); aux
    (the MoE balance loss in the reference) is 0 for the ported groups."""
    if extra:
        _not_ported("vision / audio inputs (extra)")
    h = params["embed"][tokens.long()]
    h, caches = _run_groups(params, cfg, h, want_cache=want_cache)
    logits = _norm(cfg, h, params["final_ln"]) @ params["head"]
    return logits, caches, torch.zeros((), dtype=torch.float32, device=logits.device)


def prefill(params, cfg: ArchConfig, tokens, max_len: int, extra=None):
    """Process a prompt and build a decode cache of capacity ``max_len``.

    Returns (last_logits [B, Vphys], caches): the Mamba states as the
    forward leaves them, the attention K/V copied into zeroed
    ``[.., max_len, Dh]`` buffers at offset 0, and ``pos`` = S.
    """
    b, s = tokens.shape
    logits, fwd_caches, _ = forward(params, cfg, tokens, extra, want_cache=True)
    full = init_cache(cfg, b, max_len, device=logits.device)

    def merge(dst, src):
        if dst.shape == src.shape:
            return src.to(dst.dtype)
        if dst.dim() != src.dim() or dst.shape[-1] != src.shape[-1]:
            raise ValueError(f"cache shapes {tuple(dst.shape)} and {tuple(src.shape)}")
        dst[..., :src.shape[-2], :] = src
        return dst

    merged = {"pos": s}
    for gname, src in fwd_caches.items():
        merged[gname] = _tree_map2(merge, full[gname], src)
    return logits[:, -1], merged


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


# ---------------------------------------------------------------------------
# decode: cache init + single-token step
# ---------------------------------------------------------------------------

def _attn_cache_zeros(cfg, batch, max_len, dtype, device=None):
    shape = (batch, cfg.physical_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, extra_shapes=None,
               device=None):
    """Zero decode cache matching ``decode_step`` on ``device`` (default:
    CUDA).  ``pos`` is a Python int.  With ``cfg.ring_kv_cache`` the
    attention caches are ring buffers of ``window`` slots."""
    if extra_shapes:
        _not_ported("cross-attention caches (extra_shapes)")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    if cfg.ring_kv_cache and cfg.window:
        max_len = min(max_len, cfg.window)
    conv_w = cfg.d_inner + 2 * cfg.ssm_state

    def mamba_states(n):
        return {
            "conv": torch.zeros((n, batch, cfg.conv_kernel - 1, conv_w), dtype=dtype,
                                device=dev),
            "ssm": torch.zeros((n, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                               dtype=torch.float32, device=dev),
        }

    caches = {"pos": 0}
    for gname, n in _ported_program(cfg):
        n = max(n, 1)
        if gname == "mamba":
            caches[gname] = mamba_states(n)
        else:  # zamba_super
            attn = _attn_cache_zeros(cfg, batch, max_len, dtype, dev)
            caches[gname] = {
                "mamba": tree_map(lambda t: t.reshape(n, cfg.attn_every, *t.shape[1:]),
                                  mamba_states(n * cfg.attn_every)),
                "attn": tree_map(lambda t: t.expand(n, *t.shape).contiguous(), attn),
            }
    return caches


def _decoder_block_decode(p, cfg, h, cache, pos):
    a_out, cache = attn_decode(p["attn"], cfg, _norm(cfg, h, p["ln1"]), cache, pos)
    h = h + a_out
    h = h + ffn_apply(p["ffn"], _norm(cfg, h, p["ln2"]), cfg.ffn_type)
    return h, cache


def _mamba_stack_decode(gp, cfg, h, cstack):
    """Decode through a stack of Mamba2 blocks, writing each block's new
    state into ``cstack`` in place."""
    for i in range(gp["w_in"].shape[0]):
        y, c = mamba_decode(_layer(gp, i), cfg, rmsnorm(h), _layer(cstack, i))
        h = h + y
        cstack["conv"][i] = c["conv"]
        cstack["ssm"][i] = c["ssm"]
    return h


def decode_step(params, cfg: ArchConfig, token, caches):
    """One decode step.  token: [B] int.  Returns (logits [B, Vphys], caches).

    ``caches`` is updated in place (Mamba states, the new K/V rows, ``pos``)
    and returned."""
    pos = caches["pos"]
    h = params["embed"][token.long()[:, None]]
    for gname, n in _ported_program(cfg):
        gp, cstack = params["groups"][gname], caches[gname]
        if gname == "mamba":
            h = _mamba_stack_decode(gp, cfg, h, cstack)
        else:  # zamba_super
            shared = params["shared_attn"]
            for i in range(n):
                h = _mamba_stack_decode(_layer(gp["mamba"], i), cfg, h,
                                        _layer(cstack["mamba"], i))
                h, _ = _decoder_block_decode(shared, cfg, h, _layer(cstack["attn"], i), pos)
    logits = (_norm(cfg, h, params["final_ln"]) @ params["head"])[:, 0]
    caches["pos"] = pos + 1
    return logits, caches

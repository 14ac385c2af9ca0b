"""The zoo's composable model: the ``decoder`` (dense and MoE), ``mamba``,
``zamba_super``, ``vlm_super`` and audio ``enc``/``dec`` groups.

The reference's ``repro.models.transformer`` with tensors.  A config
compiles to a *block program*, an ordered list of groups, each a stack of
layers whose parameters are stacked on a leading axis (the reference's
``lax.scan`` over stacked params becomes a Python loop over that axis):

  dense/moe   [('decoder', L)]
  ssm         [('mamba', L)]
  hybrid      [('zamba_super', L // k)] + [('mamba', L % k)]   (shared attn)
  vlm         [('vlm_super', L // k)]      (k-1 self layers + 1 cross layer)
  audio       encoder [('enc', L)] + decoder [('dec', L)]

A ``decoder`` layer is attention then an FFN, or the MoE layer
(``models.moe``) for a ``moe`` config, whose load-balancing loss the
forward sums over layers as ``aux``; decode runs the MoE at full capacity,
as the reference.  A ``zamba_super`` runs ``attn_every`` Mamba2 blocks and
then the ONE shared attention+MLP block, whose parameters (``shared_attn``)
are shared by every application, with one KV cache per application.  A
``vlm_super`` runs ``cross_attn_every - 1`` decoder layers, then one cross
layer over the vision tokens (``extra["vision"]``), its attention scaled
by ``tanh(gate)`` (an f32 leaf); the audio model encodes the frames
(``extra["frames"]``, non-causal self attention with RoPE, no cache) and
runs only the ``dec`` group over tokens, each layer self attention, cross
attention over the encoder's output and an FFN.  The cross layers' decode
caches hold the static K/V of the vision tokens or the encoder's output.
There is no ``use_pallas``: the tensors' device picks the kernel path.
The reference's layout hints (``dist.sharding.shard_hint``) stand where it
has them; they act only on the dry-run's ``DTensor``s over a mesh
(``launch.steps``) and return every plain tensor unchanged.

Entry points: ``init_params``, ``forward``, ``forward_train`` (the
causal LM loss, for ``torch.autograd``), ``prefill`` (logits + cache),
``init_cache``, ``decode_step`` (one token).  The decode caches are updated
in place.  ``use_remat`` recomputes each layer's forward in the backward
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of its
scan bodies): it changes memory, not values.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import shard_hint, shard_local
from repro_torch.models.attention import attn_apply, attn_decode, attn_init
from repro_torch.models.common import (dense_init, ffn_apply, ffn_init,
                                      layernorm_nonparametric, rmsnorm, softmax_cross_entropy,
                                      torch_dtype)
from repro_torch.models.config import ArchConfig
from repro_torch.models.mamba import mamba_apply, mamba_decode, mamba_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.params import tree_map
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trace import span

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


def _norm(cfg, x, scale):
    if cfg.nonparametric_ln:
        return layernorm_nonparametric(x)
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


def _body(use_remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under ``use_remat`` through
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept but recomputed in the backward, which the kernels repeat bit for
    bit.  The reference wraps each scan body in ``jax.checkpoint``."""
    if use_remat:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _decoder_layer_init(gen, cfg, device=None):
    dtype = torch_dtype(cfg.dtype)
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "attn": attn_init(gen, cfg, device=device),
    }
    if cfg.arch_type == "moe":
        p["moe"] = moe_init(gen, cfg, device=device)
    else:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_type, dtype, device=device)
    return p


def _cross_layer_init(gen, cfg, device=None):
    """A vlm cross layer: attention over the vision tokens, an FFN, and the
    mllama-style gate, f32 whatever ``cfg.dtype`` is."""
    dtype = torch_dtype(cfg.dtype)
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "attn": attn_init(gen, cfg, cross=True, device=device),
        "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_type, dtype, device=device),
        "gate": torch.full((1,), 0.1, dtype=torch.float32, device=device),
    }


def _dec_layer_init(gen, cfg, device=None):
    """Audio decoder layer: self attention, cross attention, FFN."""
    dtype = torch_dtype(cfg.dtype)
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "ln_x": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "self": attn_init(gen, cfg, device=device),
        "cross": attn_init(gen, cfg, cross=True, device=device),
        "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_type, dtype, device=device),
    }


def _stack_init(init_fn, gen, n, cfg, device):
    return _stack([init_fn(gen, cfg, device=device) for _ in range(n)])


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Parameter tree of ``cfg`` on ``device`` (default: CUDA).

    Draws come from ``gen`` on its own device (a CUDA generator draws on the
    card, which is much faster at full width); one seed and one generator
    device give the same weights on every target device.  Key paths, shapes
    and dtypes are the reference's (``groups/decoder/attn/wq`` has a leading
    ``[L]`` axis, ``groups/decoder/moe/w_gate`` is ``[L, E, d, f]``,
    ``groups/zamba_super/mamba/w_in`` has leading axes ``[n_super,
    attn_every]``, ``groups/vlm_super/self/attn/wq`` ``[n_super,
    cross_attn_every - 1]``, ``groups/vlm_super/cross/gate`` ``[n_super, 1]``
    in f32); the values are not.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    v = cfg.physical_vocab
    params = {
        "embed": dense_init(gen, (v, cfg.d_model), dtype, scale=0.02, device=dev),
        "head": dense_init(gen, (cfg.d_model, v), dtype, device=dev),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "groups": {},
    }
    for gname, n in build_program(cfg):
        if gname in ("decoder", "enc"):
            params["groups"][gname] = _stack_init(_decoder_layer_init, gen, n, cfg, dev)
        elif gname == "mamba":
            params["groups"][gname] = _stack_init(mamba_init, gen, n, cfg, dev)
        elif gname == "zamba_super":
            params["groups"][gname] = {"mamba": _stack(
                [_stack_init(mamba_init, gen, cfg.attn_every, cfg, dev)
                 for _ in range(n)])}
            params["shared_attn"] = _decoder_layer_init(gen, cfg, device=dev)
        elif gname == "vlm_super":
            params["groups"][gname] = {
                "self": _stack([_stack_init(_decoder_layer_init, gen, cfg.cross_attn_every - 1,
                                            cfg, dev) for _ in range(n)]),
                "cross": _stack_init(_cross_layer_init, gen, n, cfg, dev),
            }
        else:  # dec
            params["groups"][gname] = _stack_init(_dec_layer_init, gen, n, cfg, dev)
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _ffn_or_moe(p, cfg, f_in, *, full_capacity=False):
    """The layer's FFN, or its MoE over the flattened ``[B·S, d]`` tokens.
    Returns (out, aux), aux the MoE's balance loss (None for an FFN)."""
    if "moe" in p:
        b, s, d = f_in.shape
        y, aux = moe_apply(p["moe"], cfg, f_in.reshape(b * s, d), full_capacity=full_capacity)
        return y.reshape(b, s, d), aux
    return ffn_apply(p["ffn"], f_in, cfg.ffn_type), None


def _decoder_block(p, cfg, h, *, want_cache, attn_impl="blockwise", causal=True):
    """Returns (h, cache, aux)."""
    with span("attention"):
        a_out, (k, v) = attn_apply(p["attn"], cfg, _norm(cfg, h, p["ln1"]), causal=causal,
                                   attn_impl=attn_impl)
    # the port's one hint beyond the reference's: on a mesh the residual
    # keeps the activations' layout, where DTensor would otherwise shard the
    # sequence over the model axis, which torch 2.11's views cannot flatten
    h = shard_hint(h + a_out, "act")
    with span("ffn"):
        f_out, aux = _ffn_or_moe(p, cfg, _norm(cfg, h, p["ln2"]))
    return h + f_out, ({"k": k, "v": v} if want_cache else None), aux


def _decoder_layer(p, cfg, h, **kwargs):
    """A layer of the decoder, zamba_super (shared attention) and vlm_super
    groups: :func:`_decoder_block`, its output hinted to the activations'
    layout (the audio encoder's layers go without, as in the reference)."""
    h, cache, aux = _decoder_block(p, cfg, h, **kwargs)
    return shard_hint(h, "act"), cache, aux


def _cross_block(p, cfg, h, memory, *, want_cache):
    """A vlm cross layer over ``memory`` (the vision tokens), its attention
    scaled by tanh of the f32 gate.  Returns (h, cache)."""
    a_out, (k, v) = attn_apply(p["attn"], cfg, _norm(cfg, h, p["ln1"]), kv_x=memory,
                               causal=False, use_rope=False)
    h = h + torch.tanh(p["gate"]).to(h.dtype) * a_out
    h = h + ffn_apply(p["ffn"], _norm(cfg, h, p["ln2"]), cfg.ffn_type)
    return h, ({"k": k, "v": v} if want_cache else None)


def _dec_block(p, cfg, h, memory, *, want_cache):
    """An audio decoder layer: causal self attention, cross attention over
    ``memory`` (the encoder's output, no gate), FFN.  Returns (h, cache)."""
    a_out, (k, v) = attn_apply(p["self"], cfg, _norm(cfg, h, p["ln1"]))
    h = h + a_out
    x_out, (kx, vx) = attn_apply(p["cross"], cfg, _norm(cfg, h, p["ln_x"]), kv_x=memory,
                                 causal=False, use_rope=False)
    h = h + x_out
    h = shard_hint(h + ffn_apply(p["ffn"], _norm(cfg, h, p["ln2"]), cfg.ffn_type), "act")
    cache = {"self": {"k": k, "v": v}, "cross": {"k": kx, "v": vx}} if want_cache else None
    return h, cache


def _mamba_block(p, cfg, h, want_cache):
    y, st = mamba_apply(p, cfg, rmsnorm(h), return_state=want_cache)
    return shard_hint(h + y, "act"), st


def _mamba_stack(gp, cfg, h, want_cache, use_remat=False):
    states = []
    for i in range(gp["w_in"].shape[0]):
        h, st = _body(use_remat, _mamba_block, _layer(gp, i), cfg, h, want_cache)
        states.append(st)
    return h, (_stack(states) if want_cache else None)


def _run_groups(params, cfg: ArchConfig, h, extra, *, want_cache, attn_impl="blockwise",
                use_remat=False):
    """Run the block program over the groups ``params`` holds (the audio
    forward passes only ``dec``).  Returns (h, caches, aux summed over the
    decoder layers, f32).  ``use_remat``: each layer (a superblock's Mamba2
    blocks and shared attention each) through :func:`_body`."""
    caches = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for gname, n in build_program(cfg):
        if gname not in params["groups"]:
            continue
        gp = params["groups"][gname]
        if gname == "decoder":
            outs = []
            for i in range(n):
                h, cache, aux = _body(use_remat, _decoder_layer, _layer(gp, i), cfg, h,
                                      want_cache=want_cache, attn_impl=attn_impl)
                if aux is not None:
                    aux_total = aux_total + aux
                outs.append(cache)
            caches[gname] = _stack(outs) if want_cache else None
        elif gname == "mamba":
            h, caches[gname] = _mamba_stack(gp, cfg, h, want_cache, use_remat)
        elif gname == "zamba_super":
            shared = params["shared_attn"]
            outs = []
            for i in range(n):
                h, mstates = _mamba_stack(_layer(gp["mamba"], i), cfg, h, want_cache, use_remat)
                h, acache, _ = _body(use_remat, _decoder_layer, shared, cfg, h,
                                     want_cache=want_cache, attn_impl=attn_impl)
                outs.append({"mamba": mstates, "attn": acache})
            caches[gname] = _stack(outs) if want_cache else None
        elif gname == "vlm_super":
            outs = []
            for i in range(n):
                sp, scaches = _layer(gp["self"], i), []
                for j in range(cfg.cross_attn_every - 1):
                    h, cache, _ = _body(use_remat, _decoder_layer, _layer(sp, j), cfg, h,
                                        want_cache=want_cache, attn_impl=attn_impl)
                    scaches.append(cache)
                h, xcache = _body(use_remat, _cross_block, _layer(gp["cross"], i), cfg, h,
                                  extra["vision"], want_cache=want_cache)
                outs.append({"self": _stack(scaches) if want_cache else None, "cross": xcache})
            caches[gname] = _stack(outs) if want_cache else None
        elif gname == "dec":
            outs = []
            for i in range(n):
                h, cache = _body(use_remat, _dec_block, _layer(gp, i), cfg, h, extra["memory"],
                                 want_cache=want_cache)
                outs.append(cache)
            caches[gname] = _stack(outs) if want_cache else None
    return h, (caches if want_cache else {}), aux_total


def _encode(params, cfg, frames, use_remat=False):
    """The audio encoder over the frame embeddings [B, Sf, d] (the frontend
    is a stub, as in the reference): decoder layers with non-causal self
    attention (RoPE applied); no cache."""
    h = frames.to(torch_dtype(cfg.dtype))
    gp = params["groups"]["enc"]
    for i in range(gp["ln1"].shape[0]):
        h, _, _ = _body(use_remat, _decoder_block, _layer(gp, i), cfg, h, want_cache=False,
                        causal=False)
    return h


def _lookup(tokens, table):
    return table[tokens]


def forward(params, cfg: ArchConfig, tokens, extra=None, *, want_cache=False,
            attn_impl: str = "blockwise", use_remat: bool = False):
    """tokens: [B, S] int; ``extra``: ``{"vision": [B, Tv, d]}`` for a vlm
    config, ``{"frames": [B, Sf, d]}`` for an audio one.  Returns (logits
    [B, S, Vphys], caches, aux); aux is the MoE balance loss summed over
    the decoder layers (f32, 0 without MoE).  The audio model's caches also
    hold the encoder's output (``enc_memory``).  ``attn_impl``:
    ``"blockwise"`` or ``"banded"`` (one function on the port; see
    ``models.attention.attn_apply``).  ``use_remat``: recompute each layer
    in the backward (:func:`_body`)."""
    extra = extra or {}
    # on a mesh the lookup is shard-local over the batch, the table gathered
    # first (as FSDP gathers a weight before its use): torch 2.11's DTensor
    # has no working rule for the lookup's gradient
    h = shard_hint(shard_local(_lookup, (tokens.long(), params["embed"]),
                               ((0, None), (None, None)), out_dims=(0, None)), "act")
    if cfg.arch_type == "audio":
        memory = _encode(params, cfg, extra["frames"], use_remat)
        dec_params = {"groups": {"dec": params["groups"]["dec"]}}
        h, caches, aux = _run_groups(dec_params, cfg, h, dict(extra, memory=memory),
                                     want_cache=want_cache, attn_impl=attn_impl,
                                     use_remat=use_remat)
        if want_cache:
            caches["enc_memory"] = memory
    else:
        h, caches, aux = _run_groups(params, cfg, h, extra, want_cache=want_cache,
                                     attn_impl=attn_impl, use_remat=use_remat)
    logits = shard_hint(_norm(cfg, h, params["final_ln"]) @ params["head"], "logits")
    return logits, caches, aux


def forward_train(params, cfg: ArchConfig, batch, *, use_remat: bool = True,
                  attn_impl: str = "blockwise", aux_weight: float = 0.01):
    """The causal LM loss, f32 scalar.  ``batch``: ``{"tokens", "labels",
    [extras]}`` ([B, S] int each, labels -1 where masked; a vlm's
    ``vision``, an audio model's ``frames``).  The vocabulary's padding
    columns get -1e30 before the softmax; the loss is
    :func:`~repro_torch.models.common.softmax_cross_entropy` of the labels
    (clamped at 0) under the mask ``labels >= 0``, plus ``aux_weight`` times
    the MoE balance loss.  The reference's ``forward_train``."""
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    logits, _, aux = forward(params, cfg, batch["tokens"], extra, use_remat=use_remat,
                             attn_impl=attn_impl)
    if cfg.physical_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.physical_vocab, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full((), -1e30, dtype=logits.dtype,
                                             device=logits.device), logits)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    loss = softmax_cross_entropy(logits, labels.clamp_min(0), mask)
    return loss + aux_weight * aux


def prefill(params, cfg: ArchConfig, tokens, max_len: int, extra=None,
            attn_impl: str = "blockwise"):
    """Process a prompt and build a decode cache of capacity ``max_len``.

    Returns (last_logits [B, Vphys], caches): the Mamba states as the
    forward leaves them, the attention K/V copied into zeroed
    ``[.., max_len, Dh]`` buffers at offset 0, the cross layers' K/V whole
    (as many slots as vision tokens or frames, in the cache's dtype), and
    ``pos`` = S.  A ring cache (``cfg.ring_kv_cache``, ``window`` slots)
    shorter than the prompt keeps the prompt's last ``window`` positions,
    position p at slot p % window, where decode goes on writing (the
    reference's prefill refuses a prompt longer than its ring).
    """
    extra = extra or {}
    b, s = tokens.shape
    with span("prefill"):
        logits, fwd_caches, _ = forward(params, cfg, tokens, extra, want_cache=True,
                                        attn_impl=attn_impl)
        fwd_caches.pop("enc_memory", None)   # cached per dec layer as cross K/V
        extra_shapes = {}
        if "vision" in extra:
            extra_shapes["vision_len"] = extra["vision"].shape[1]
        if "frames" in extra:
            extra_shapes["memory_len"] = extra["frames"].shape[1]
        ring = bool(cfg.ring_kv_cache and cfg.window)

        def merge(dst, src):
            if dst.shape == src.shape:
                return src.to(dst.dtype)
            if dst.dim() != src.dim() or dst.shape[-1] != src.shape[-1]:
                raise ValueError(f"cache shapes {tuple(dst.shape)} and {tuple(src.shape)}")
            n, cap = src.shape[-2], dst.shape[-2]
            if n > cap:
                if not ring:
                    raise ValueError(f"a prompt of {n} positions does not fit a cache of {cap}")
                src = torch.roll(src[..., n - cap:, :], shifts=(n - cap) % cap, dims=-2)
                n = cap
            dst[..., :n, :] = src
            return dst

        with span("cache"):
            full = init_cache(cfg, b, max_len, extra_shapes, device=logits.device)
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

def _attn_cache_zeros(cfg, batch, max_len, dtype, device=None, lead=()):
    shape = (*lead, batch, cfg.physical_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, extra_shapes=None,
               device=None):
    """Zero decode cache matching ``decode_step`` on ``device`` (default:
    CUDA).  ``pos`` is a Python int.  With ``cfg.ring_kv_cache`` the
    attention caches are ring buffers of ``window`` slots.  ``extra_shapes``
    sizes the cross caches: ``vision_len`` (default
    ``cfg.num_vision_tokens``) and ``memory_len`` (default 1,024), as the
    reference's."""
    extra_shapes = extra_shapes or {}
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

    def attn_zeros(*lead, slots=max_len):
        return _attn_cache_zeros(cfg, batch, slots, dtype, dev, lead)

    caches = {"pos": 0}
    for gname, n in build_program(cfg):
        n = max(n, 1)
        if gname == "decoder":
            caches[gname] = attn_zeros(n)
        elif gname == "mamba":
            caches[gname] = mamba_states(n)
        elif gname == "zamba_super":
            caches[gname] = {
                "mamba": tree_map(lambda t: t.reshape(n, cfg.attn_every, *t.shape[1:]),
                                  mamba_states(n * cfg.attn_every)),
                "attn": attn_zeros(n),
            }
        elif gname == "vlm_super":
            caches[gname] = {
                "self": attn_zeros(n, cfg.cross_attn_every - 1),
                "cross": attn_zeros(n, slots=extra_shapes.get("vision_len",
                                                              cfg.num_vision_tokens)),
            }
        elif gname == "dec":
            caches[gname] = {"self": attn_zeros(n),
                             "cross": attn_zeros(n, slots=extra_shapes.get("memory_len", 1024))}
        # 'enc' has no decode-time cache
    return caches


def _decoder_block_decode(p, cfg, h, cache, pos):
    a_out, cache = attn_decode(p["attn"], cfg, _norm(cfg, h, p["ln1"]), cache, pos)
    h = h + a_out
    f_out, _ = _ffn_or_moe(p, cfg, _norm(cfg, h, p["ln2"]), full_capacity=True)
    return shard_hint(h + f_out, "act"), cache


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
    h = shard_hint(params["embed"][token.long()[:, None]], "act")
    for gname, n in build_program(cfg):
        if gname == "enc":
            continue
        gp, cstack = params["groups"][gname], caches[gname]
        if gname == "decoder":
            for i in range(n):
                h, _ = _decoder_block_decode(_layer(gp, i), cfg, h, _layer(cstack, i), pos)
        elif gname == "mamba":
            h = _mamba_stack_decode(gp, cfg, h, cstack)
        elif gname == "zamba_super":
            shared = params["shared_attn"]
            for i in range(n):
                h = _mamba_stack_decode(_layer(gp["mamba"], i), cfg, h,
                                        _layer(cstack["mamba"], i))
                h, _ = _decoder_block_decode(shared, cfg, h, _layer(cstack["attn"], i), pos)
        elif gname == "vlm_super":
            for i in range(n):
                sp, sc = _layer(gp["self"], i), _layer(cstack["self"], i)
                for j in range(cfg.cross_attn_every - 1):
                    h, _ = _decoder_block_decode(_layer(sp, j), cfg, h, _layer(sc, j), pos)
                xp = _layer(gp["cross"], i)
                a_out, _ = attn_decode(xp["attn"], cfg, _norm(cfg, h, xp["ln1"]),
                                       _layer(cstack["cross"], i), pos, cross=True)
                h = h + torch.tanh(xp["gate"]).to(h.dtype) * a_out
                h = h + ffn_apply(xp["ffn"], _norm(cfg, h, xp["ln2"]), cfg.ffn_type)
        else:  # dec
            for i in range(n):
                p, c = _layer(gp, i), _layer(cstack, i)
                a_out, _ = attn_decode(p["self"], cfg, _norm(cfg, h, p["ln1"]), c["self"], pos)
                h = h + a_out
                x_out, _ = attn_decode(p["cross"], cfg, _norm(cfg, h, p["ln_x"]), c["cross"],
                                       pos, cross=True)
                h = h + x_out
                h = h + ffn_apply(p["ffn"], _norm(cfg, h, p["ln2"]), cfg.ffn_type)
    logits = shard_hint(_norm(cfg, h, params["final_ln"]) @ params["head"], "logits")[:, 0]
    caches["pos"] = pos + 1
    return logits, caches

"""The zoo's composable model: the ``decoder`` (dense and MoE), ``mamba``,
``zamba_super``, ``vlm_super``, ``granite_hybrid`` and audio ``enc``/``dec``
groups.

The reference's ``repro.models.transformer`` with tensors.  A config
compiles to a *block program*, an ordered list of groups, each a stack of
layers whose parameters are stacked on a leading axis (the reference's
``lax.scan`` over stacked params becomes a Python loop over the layers that
:func:`_layers` unbinds from each leaf once, so that under grad each leaf's
gradient is one ``stack`` of the layers' gradients, as the scan writes each
into its slice):

  dense/moe   [('decoder', L)]
  ssm         [('mamba', L)]
  hybrid      [('zamba_super', L // k)] + [('mamba', L % k)]   (shared attn)
  vlm         [('vlm_super', L // k)]      (k-1 self layers + 1 cross layer)
  audio       encoder [('enc', L)] + decoder [('dec', L)]
  granite_hybrid [('granite_hybrid', L)]   (a Mamba2 or attention mixer a
              layer, as ``layer_pattern`` orders them, each then an MoE)

Each group name has one entry in :data:`GROUPS`: the parameters it draws,
its pass over the sequence (forward, prefill, training), its decode cache and
its pass over one decode token, which the entry points call in program order.

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
A ``granite_hybrid`` layer (granite-4.0-h-small, ``configs.GraniteHybridConfig``)
is ``h += r·mixer(rms(h, ln1))`` then ``h += r·(moe(x) + shared(x))`` with
``x = rms(h, ln2)``: the mixer Mamba2 (``M``) or NoPE GQA attention at the
softmax scale ``attention_multiplier`` (``A``), the MoE dropless
(``models.moe.moe_apply_dropless``), the shared expert a SwiGLU, ``r`` the
``residual_multiplier``, every RMSNorm at ``rms_norm_eps``; its params hold
the stacks ``mamba`` and ``attn`` of the two kinds of mixer, in pattern
order, beside the per-layer ``ln1``, ``ln2``, ``moe`` and ``shared``, and
its cache the Mamba states of the ``M`` layers and the K/V of the ``A``
layers.  Its embedding is scaled by ``embedding_multiplier``, the head is
the embedding's transpose and the logits are divided by
``logits_scaling``.
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

from collections import namedtuple
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import is_dtensor, shard_hint, shard_local
from repro_torch.models.attention import attn_apply, attn_decode, attn_init
from repro_torch.models.common import (dense_init, ffn_apply, ffn_init,
                                      layernorm_nonparametric, rmsnorm, softmax_cross_entropy,
                                      torch_dtype)
from repro_torch.models.config import ArchConfig
from repro_torch.models.mamba import mamba_apply, mamba_decode, mamba_init
from repro_torch.models.moe import moe_apply, moe_apply_dropless, moe_init
from repro_torch.params import tree_leaves, tree_map, tree_unflatten
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
    if cfg.arch_type == "granite_hybrid":
        if len(cfg.layer_pattern) != cfg.num_layers or set(cfg.layer_pattern) - {"M", "A"}:
            raise ValueError(f"layer_pattern {cfg.layer_pattern!r} must give each of the "
                             f"{cfg.num_layers} layers M or A")
        if not cfg.tie_word_embeddings:
            raise ValueError("the granite_hybrid group runs its head tied to the embedding")
        return [("granite_hybrid", cfg.num_layers)]
    raise ValueError(cfg.arch_type)


def _norm(cfg, x, scale):
    if cfg.nonparametric_ln:
        return layernorm_nonparametric(x)
    return rmsnorm(x, scale)


def _layers(stacked) -> list:
    """Every layer of a stacked tree, one tree of views a layer: each leaf
    unbound once along its leading axis.  Under grad a leaf's backward is
    then one ``stack`` of its layers' gradients (a ``t[i]`` per layer would
    cost L zero-filled full-size gradients and their sum); without grad
    nothing launches, and a decode cache written through the views is
    written in place.  A dry-run ``DTensor`` sharded along its leading
    (layer) axis, which ``DTensor`` refuses to unbind (FSDP's rule shards a
    stacked vector leaf's penultimate dim, its layer axis, over ``data``),
    is taken a layer at a time by ``t[i]``."""
    parts = [[t[i] for i in range(t.shape[0])]
             if is_dtensor(t) and any(p.is_shard(0) for p in t.placements)
             else torch.unbind(t, 0) for t in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [p[i] for p in parts]) for i in range(len(parts[0]))]


def _stack(trees):
    if not trees:
        return None
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _stack_init(layer_init, gen, cfg, n, dev, params=None):
    """``n`` layers of ``layer_init`` stacked (bound to it, a group's init)."""
    return _stack([layer_init(gen, cfg, device=dev) for _ in range(n)])


def _body(use_remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under ``use_remat`` through
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept but recomputed in the backward, which the kernels repeat bit for
    bit.  The reference wraps each scan body in ``jax.checkpoint``."""
    if use_remat:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# layers: init, sequence pass, decode step
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


def _granite_hybrid_layer_init(gen, cfg, device=None):
    """A granite_hybrid layer's parts beside its mixer: the two norms, the
    MoE and the shared expert."""
    dtype = torch_dtype(cfg.dtype)
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "moe": moe_init(gen, cfg, device=device),
        "shared": ffn_init(gen, cfg.d_model, cfg.shared_d_ff, "swiglu", dtype, device=device),
    }


def _ffn_or_moe(p, cfg, f_in, *, full_capacity=False):
    """The layer's FFN, or its MoE over the flattened ``[B·S, d]`` tokens.
    Returns (out, aux), aux the MoE's balance loss (None for an FFN)."""
    if "moe" in p:
        b, s, d = f_in.shape
        y, aux = moe_apply(p["moe"], cfg, f_in.reshape(b * s, d), full_capacity=full_capacity)
        return y.reshape(b, s, d), aux
    return ffn_apply(p["ffn"], f_in, cfg.ffn_type), None


def _decoder_block(p, cfg, h, *, want_cache, causal=True):
    """Returns (h, cache, aux)."""
    with span("attention"):
        a_out, (k, v) = attn_apply(p["attn"], cfg, _norm(cfg, h, p["ln1"]), causal=causal)
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


def _decoder_block_decode(p, cfg, h, cache, pos):
    a_out, cache = attn_decode(p["attn"], cfg, _norm(cfg, h, p["ln1"]), cache, pos)
    h = h + a_out
    f_out, _ = _ffn_or_moe(p, cfg, _norm(cfg, h, p["ln2"]), full_capacity=True)
    return shard_hint(h + f_out, "act"), cache


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


def _mamba_decode_into(p, cfg, x1, cache, eps=1e-6):
    """``mamba_decode``'s y, its new state written into ``cache`` in place."""
    y, new = mamba_decode(p, cfg, x1, cache, eps=eps)
    cache["conv"].copy_(new["conv"])
    cache["ssm"].copy_(new["ssm"])
    return y


def _moe_shared(p, cfg, x):
    """A granite_hybrid layer's feed-forward part on ``x`` [B, S, d]: the
    dropless MoE plus the shared expert.  Returns (out, aux)."""
    b, s, d = x.shape
    y, aux = moe_apply_dropless(p["moe"], cfg, x.reshape(b * s, d))
    return y.reshape(b, s, d) + ffn_apply(p["shared"], x, "swiglu"), aux


def _granite_hybrid_layer(p, mix, kind, cfg, h, want_cache):
    """One granite_hybrid layer: the mixer ``mix`` of ``kind`` (``M`` or
    ``A``) in the ``mamba`` or ``attention`` span, the MoE and shared expert
    in the ``moe`` span, each added at the residual multiplier.  Returns (h,
    the mixer's cache or None, aux)."""
    eps, r = cfg.rms_norm_eps, cfg.residual_multiplier
    if kind == "M":
        with span("mamba"):
            y, state = mamba_apply(mix, cfg, rmsnorm(h, p["ln1"], eps),
                                   return_state=want_cache, eps=eps)
    else:
        with span("attention"):
            y, (k, v) = attn_apply(mix, cfg, rmsnorm(h, p["ln1"], eps),
                                   use_rope=cfg.position_embedding_type != "nope",
                                   scale=cfg.attention_multiplier)
        state = {"k": k, "v": v} if want_cache else None
    h = h + y * r
    with span("moe"):
        f, aux = _moe_shared(p, cfg, rmsnorm(h, p["ln2"], eps))
    return h + f * r, state, aux


# ---------------------------------------------------------------------------
# groups, each its four functions (``gp``: its parameters; ``aux``: its MoE
# balance loss, or None):
#   init(gen, cfg, n, device, params) -> gp
#   run(params, gp, cfg, h, extra, want_cache, use_remat) -> (h, cache, aux)
#   cache(cfg, n, attn_zeros, mamba_zeros, extra_shapes) -> its decode cache
#   decode(params, gp, cfg, h, cache, pos) -> h, the cache written in place
# ---------------------------------------------------------------------------

_Group = namedtuple("_Group", "init run cache decode")


def _decoder_run(params, gp, cfg, h, extra, want_cache, use_remat):
    caches, aux_sum = [], None
    for p in _layers(gp):
        h, cache, aux = _body(use_remat, _decoder_layer, p, cfg, h, want_cache=want_cache)
        if aux is not None:
            aux_sum = aux if aux_sum is None else aux_sum + aux
        caches.append(cache)
    return h, (_stack(caches) if want_cache else None), aux_sum


def _decoder_decode(params, gp, cfg, h, cstack, pos):
    for p, c in zip(_layers(gp), _layers(cstack)):
        h, _ = _decoder_block_decode(p, cfg, h, c, pos)
    return h


def _mamba_run(params, gp, cfg, h, extra, want_cache, use_remat):
    states = []
    for p in _layers(gp):
        h, st = _body(use_remat, _mamba_block, p, cfg, h, want_cache)
        states.append(st)
    return h, (_stack(states) if want_cache else None), None


def _mamba_decode(params, gp, cfg, h, cstack, pos):
    for p, c in zip(_layers(gp), _layers(cstack)):
        h = h + _mamba_decode_into(p, cfg, rmsnorm(h), c)
    return h


def _zamba_init(gen, cfg, n, dev, params):
    """``[n, attn_every]`` Mamba2 stacks; the shared attention block, drawn
    after them, goes to the top level (``shared_attn``)."""
    gp = {"mamba": _stack([_stack_init(mamba_init, gen, cfg, cfg.attn_every, dev)
                           for _ in range(n)])}
    params["shared_attn"] = _decoder_layer_init(gen, cfg, device=dev)
    return gp


def _zamba_run(params, gp, cfg, h, extra, want_cache, use_remat):
    outs = []
    for mp in _layers(gp["mamba"]):
        h, mstates, _ = _mamba_run(params, mp, cfg, h, extra, want_cache, use_remat)
        h, acache, _ = _body(use_remat, _decoder_layer, params["shared_attn"], cfg, h,
                             want_cache=want_cache)
        outs.append({"mamba": mstates, "attn": acache})
    return h, (_stack(outs) if want_cache else None), None


def _zamba_cache(cfg, n, attn_zeros, mamba_zeros, extra_shapes):
    return {"mamba": mamba_zeros(n, cfg.attn_every), "attn": attn_zeros(n)}


def _zamba_decode(params, gp, cfg, h, cstack, pos):
    for mp, mc, ac in zip(_layers(gp["mamba"]), _layers(cstack["mamba"]),
                          _layers(cstack["attn"])):
        h = _mamba_decode(params, mp, cfg, h, mc, pos)
        h, _ = _decoder_block_decode(params["shared_attn"], cfg, h, ac, pos)
    return h


def _vlm_init(gen, cfg, n, dev, params):
    """``[n, cross_attn_every - 1]`` self layers, then ``n`` cross layers."""
    return {"self": _stack([_stack_init(_decoder_layer_init, gen, cfg, cfg.cross_attn_every - 1,
                                        dev) for _ in range(n)]),
            "cross": _stack_init(_cross_layer_init, gen, cfg, n, dev)}


def _vlm_run(params, gp, cfg, h, extra, want_cache, use_remat):
    outs = []
    for sp, xp in zip(_layers(gp["self"]), _layers(gp["cross"])):
        h, scache, _ = _decoder_run(params, sp, cfg, h, extra, want_cache, use_remat)
        h, xcache = _body(use_remat, _cross_block, xp, cfg, h, extra["vision"],
                          want_cache=want_cache)
        outs.append({"self": scache, "cross": xcache})
    return h, (_stack(outs) if want_cache else None), None


def _vlm_cache(cfg, n, attn_zeros, mamba_zeros, extra_shapes):
    return {"self": attn_zeros(n, cfg.cross_attn_every - 1),
            "cross": attn_zeros(n, slots=extra_shapes.get("vision_len", cfg.num_vision_tokens))}


def _vlm_decode(params, gp, cfg, h, cstack, pos):
    for sp, sc, xp, xc in zip(_layers(gp["self"]), _layers(cstack["self"]),
                              _layers(gp["cross"]), _layers(cstack["cross"])):
        h = _decoder_decode(params, sp, cfg, h, sc, pos)
        a_out, _ = attn_decode(xp["attn"], cfg, _norm(cfg, h, xp["ln1"]), xc, pos, cross=True)
        h = h + torch.tanh(xp["gate"]).to(h.dtype) * a_out
        h = h + ffn_apply(xp["ffn"], _norm(cfg, h, xp["ln2"]), cfg.ffn_type)
    return h


def _dec_run(params, gp, cfg, h, extra, want_cache, use_remat):
    outs = []
    for p in _layers(gp):
        h, cache = _body(use_remat, _dec_block, p, cfg, h, extra["memory"],
                         want_cache=want_cache)
        outs.append(cache)
    return h, (_stack(outs) if want_cache else None), None


def _dec_cache(cfg, n, attn_zeros, mamba_zeros, extra_shapes):
    return {"self": attn_zeros(n),
            "cross": attn_zeros(n, slots=extra_shapes.get("memory_len", 1024))}


def _dec_decode(params, gp, cfg, h, cstack, pos):
    for p, c in zip(_layers(gp), _layers(cstack)):
        a_out, _ = attn_decode(p["self"], cfg, _norm(cfg, h, p["ln1"]), c["self"], pos)
        h = h + a_out
        x_out, _ = attn_decode(p["cross"], cfg, _norm(cfg, h, p["ln_x"]), c["cross"], pos,
                               cross=True)
        h = h + x_out
        h = h + ffn_apply(p["ffn"], _norm(cfg, h, p["ln2"]), cfg.ffn_type)
    return h


_HYBRID_LAYER = ("ln1", "ln2", "moe", "shared")


def _granite_hybrid_init(gen, cfg, n, dev, params):
    """The layers' stacks and the two stacks of mixers, in pattern order."""
    return {
        **_stack_init(_granite_hybrid_layer_init, gen, cfg, n, dev),
        "mamba": _stack_init(mamba_init, gen, cfg, cfg.layer_pattern.count("M"), dev),
        "attn": _stack_init(attn_init, gen, cfg, cfg.layer_pattern.count("A"), dev),
    }


def _granite_hybrid_run(params, gp, cfg, h, extra, want_cache, use_remat):
    """The layers in pattern order, each through :func:`_body`."""
    mixers = {"M": iter(_layers(gp["mamba"])), "A": iter(_layers(gp["attn"]))}
    states = {"M": [], "A": []}
    aux_total = 0.0
    for p, kind in zip(_layers({n: gp[n] for n in _HYBRID_LAYER}), cfg.layer_pattern):
        h, state, aux = _body(use_remat, _granite_hybrid_layer, p, next(mixers[kind]), kind,
                              cfg, h, want_cache)
        states[kind].append(state)
        aux_total = aux_total + aux
    cache = {"mamba": _stack(states["M"]), "attn": _stack(states["A"])} if want_cache else None
    return h, cache, aux_total


def _granite_hybrid_cache(cfg, n, attn_zeros, mamba_zeros, extra_shapes):
    return {"mamba": mamba_zeros(cfg.layer_pattern.count("M")),
            "attn": attn_zeros(cfg.layer_pattern.count("A"))}


def _granite_hybrid_decode(params, gp, cfg, h, cstack, pos):
    """Each layer's new Mamba2 state or K/V row written into ``cstack``."""
    eps, r = cfg.rms_norm_eps, cfg.residual_multiplier
    mixers = {"M": iter(zip(_layers(gp["mamba"]), _layers(cstack["mamba"]))),
              "A": iter(zip(_layers(gp["attn"]), _layers(cstack["attn"])))}
    for p, kind in zip(_layers({n: gp[n] for n in _HYBRID_LAYER}), cfg.layer_pattern):
        mix, c = next(mixers[kind])
        x = rmsnorm(h, p["ln1"], eps)
        if kind == "M":
            y = _mamba_decode_into(mix, cfg, x, c, eps=eps)
        else:
            y, _ = attn_decode(mix, cfg, x, c, pos,
                               use_rope=cfg.position_embedding_type != "nope",
                               scale=cfg.attention_multiplier)
        h = h + y * r
        f, _ = _moe_shared(p, cfg, rmsnorm(h, p["ln2"], eps))
        h = h + f * r
    return h


GROUPS = {
    "decoder": _Group(partial(_stack_init, _decoder_layer_init), _decoder_run,
                      lambda cfg, n, attn, mamba, shapes: attn(n), _decoder_decode),
    "mamba": _Group(partial(_stack_init, mamba_init), _mamba_run,
                    lambda cfg, n, attn, mamba, shapes: mamba(n), _mamba_decode),
    "zamba_super": _Group(_zamba_init, _zamba_run, _zamba_cache, _zamba_decode),
    "vlm_super": _Group(_vlm_init, _vlm_run, _vlm_cache, _vlm_decode),
    # the audio encoder: :func:`forward` runs it (:func:`_encode`) ahead of
    # the dec group, whose cross caches hold its output; nothing to decode
    "enc": _Group(partial(_stack_init, _decoder_layer_init), None, None, None),
    "dec": _Group(partial(_stack_init, _dec_layer_init), _dec_run, _dec_cache, _dec_decode),
    "granite_hybrid": _Group(_granite_hybrid_init, _granite_hybrid_run, _granite_hybrid_cache,
                             _granite_hybrid_decode),
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

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
    in f32); the values are not.  A ``granite_hybrid`` configuration has
    no ``head`` (it is tied to ``embed``).
    """
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    v = cfg.physical_vocab
    params = {
        "embed": dense_init(gen, (v, cfg.d_model), dtype, scale=0.02, device=dev),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "groups": {},
    }
    if cfg.arch_type != "granite_hybrid":
        params["head"] = dense_init(gen, (cfg.d_model, v), dtype, device=dev)
    for gname, n in build_program(cfg):
        params["groups"][gname] = GROUPS[gname].init(gen, cfg, n, dev, params)
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _run_groups(params, cfg: ArchConfig, h, extra, *, want_cache, use_remat=False):
    """Run the block program's groups over the sequence (the audio
    encoder's is :func:`_encode`).  Returns (h, caches, aux summed over the
    MoE layers, f32).  ``use_remat``: each layer (a superblock's Mamba2
    blocks and shared attention each) through :func:`_body`."""
    caches = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for gname, _ in build_program(cfg):
        run = GROUPS[gname].run
        if run is None:
            continue
        h, caches[gname], aux = run(params, params["groups"][gname], cfg, h, extra,
                                    want_cache, use_remat)
        if aux is not None:
            aux_total = aux_total + aux
    return h, (caches if want_cache else {}), aux_total


def _encode(params, cfg, frames, use_remat=False):
    """The audio encoder over the frame embeddings [B, Sf, d] (the frontend
    is a stub, as in the reference): decoder layers with non-causal self
    attention (RoPE applied); no cache."""
    h = frames.to(torch_dtype(cfg.dtype))
    for p in _layers(params["groups"]["enc"]):
        h, _, _ = _body(use_remat, _decoder_block, p, cfg, h, want_cache=False, causal=False)
    return h


def _lookup(tokens, table):
    return table[tokens]


def _embed(cfg, h):
    """``h``, the embedding rows, scaled by a granite_hybrid configuration's
    ``embedding_multiplier``."""
    return h * cfg.embedding_multiplier if cfg.arch_type == "granite_hybrid" else h


def _logits(params, cfg, h):
    """The final norm and the head: ``head``, or for a granite_hybrid
    configuration the embedding's transpose, the logits divided by its
    ``logits_scaling``."""
    if cfg.arch_type != "granite_hybrid":
        return shard_hint(_norm(cfg, h, params["final_ln"]) @ params["head"], "logits")
    out = rmsnorm(h, params["final_ln"], cfg.rms_norm_eps) @ params["embed"].T
    return shard_hint(out.div_(cfg.logits_scaling), "logits")


def forward(params, cfg: ArchConfig, tokens, extra=None, *, want_cache=False,
            use_remat: bool = False):
    """tokens: [B, S] int; ``extra``: ``{"vision": [B, Tv, d]}`` for a vlm
    config, ``{"frames": [B, Sf, d]}`` for an audio one.  Returns (logits
    [B, S, Vphys], caches, aux); aux is the MoE balance loss summed over
    the MoE layers (f32, 0 without MoE).  The audio model's caches also
    hold the encoder's output (``enc_memory``).  ``use_remat``: recompute
    each layer in the backward (:func:`_body`)."""
    extra = extra or {}
    # on a mesh the lookup is shard-local over the batch, the table gathered
    # first (as FSDP gathers a weight before its use): torch 2.11's DTensor
    # has no working rule for the lookup's gradient
    h = shard_hint(_embed(cfg, shard_local(_lookup, (tokens.long(), params["embed"]),
                                                   ((0, None), (None, None)),
                                                   out_dims=(0, None))), "act")
    if cfg.arch_type == "audio":
        extra = dict(extra, memory=_encode(params, cfg, extra["frames"], use_remat))
    h, caches, aux = _run_groups(params, cfg, h, extra, want_cache=want_cache,
                                 use_remat=use_remat)
    if want_cache and cfg.arch_type == "audio":
        caches["enc_memory"] = extra["memory"]
    return _logits(params, cfg, h), caches, aux


def forward_train(params, cfg: ArchConfig, batch, *, use_remat: bool = True,
                  aux_weight: float = 0.01):
    """The causal LM loss, f32 scalar.  ``batch``: ``{"tokens", "labels",
    [extras]}`` ([B, S] int each, labels -1 where masked; a vlm's
    ``vision``, an audio model's ``frames``).  The vocabulary's padding
    columns get -1e30 before the softmax; the loss is
    :func:`~repro_torch.models.common.softmax_cross_entropy` of the labels
    (clamped at 0) under the mask ``labels >= 0``, plus ``aux_weight`` times
    the MoE balance loss.  The reference's ``forward_train``."""
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    logits, _, aux = forward(params, cfg, batch["tokens"], extra, use_remat=use_remat)
    if cfg.physical_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.physical_vocab, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full((), -1e30, dtype=logits.dtype,
                                             device=logits.device), logits)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    loss = softmax_cross_entropy(logits, labels.clamp_min(0), mask)
    return loss + aux_weight * aux


def prefill(params, cfg: ArchConfig, tokens, max_len: int, extra=None):
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
        logits, fwd_caches, _ = forward(params, cfg, tokens, extra, want_cache=True)
        fwd_caches.pop("enc_memory", None)   # cached per dec layer as cross K/V
        extra_shapes = {name: extra[key].shape[1] for key, name in
                        (("vision", "vision_len"), ("frames", "memory_len")) if key in extra}
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
                merged[gname] = tree_map(merge, full[gname], src)
        return logits[:, -1], merged


# ---------------------------------------------------------------------------
# decode: cache init + single-token step
# ---------------------------------------------------------------------------

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

    def mamba_zeros(*lead):
        return {
            "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1, conv_w), dtype=dtype,
                                device=dev),
            "ssm": torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                               dtype=torch.float32, device=dev),
        }

    def attn_zeros(*lead, slots=max_len):
        shape = (*lead, batch, cfg.physical_kv_heads, slots, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    caches = {"pos": 0}
    for gname, n in build_program(cfg):
        cache = GROUPS[gname].cache
        if cache is not None:
            caches[gname] = cache(cfg, max(n, 1), attn_zeros, mamba_zeros, extra_shapes)
    return caches


def decode_step(params, cfg: ArchConfig, token, caches):
    """One decode step.  token: [B] int.  Returns (logits [B, Vphys], caches).

    ``caches`` is updated in place (Mamba states, the new K/V rows, ``pos``)
    and returned."""
    pos = caches["pos"]
    h = shard_hint(_embed(cfg, params["embed"][token.long()[:, None]]), "act")
    for gname, _ in build_program(cfg):
        decode = GROUPS[gname].decode
        if decode is not None:
            h = decode(params, params["groups"][gname], cfg, h, caches[gname], pos)
    logits = _logits(params, cfg, h)[:, 0]
    caches["pos"] = pos + 1
    return logits, caches

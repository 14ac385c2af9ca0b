"""Mixture-of-Experts layer: a top-k router and two dispatches, by capacity
and dropless.

Which configuration takes which path:

* capacity (:func:`moe_apply`): phi3.5-moe-42b-a6.6b and mixtral-8x22b,
  the ``decoder`` group's MoE layers.  It is the reference's
  ``repro.models.moe``, whose dispatch, drops and counts the port's
  tests and dry-run hold it to, so it stays as it is for the two; with 16
  or 8 experts at top-2 its ``[E, C, d]`` buffer costs little.
* dropless (:func:`moe_apply_dropless`): granite-4.0-h-small, every layer
  of the ``granite_hybrid`` group.  The published model drops nothing,
  and at its 72 experts top-10 the capacity path could not serve it: at
  8,192 tokens a capacity factor of 1.25 gives each expert 1,423 slots
  and drops whatever is routed beyond them, and full capacity would be an
  ``[E, k·T, d]`` buffer of 48 GB.

The capacity path.  The reference's ``repro.models.moe`` with tensors.  Every expert GEMM stays
dense over a fixed ``[E, C, d]`` expert buffer filled by a gather (plain
batched matrix products, ``torch.bmm``: the reference computes them outside
any Pallas kernel).  Routing runs as the reference's single group (its
``_num_groups`` is 1 without a mesh), on a mesh too: the dry-run's counts
then equal the one-card step's.  On a mesh (``launch.steps``) the tokens,
the expert buffer and the expert weights get the reference's layout hints
(``dist.sharding.shard_spec``), which do nothing elsewhere.

Capacity: ``C = int(ceil(k·T / E) · capacity_factor) + 1``, or ``k·T``
under ``full_capacity``; overflowed assignments drop (their gate mass is
lost).  The router also returns the Switch/Mixtral load-balancing loss.

Order is explicit where the reference's ops define it: the top-k breaks
ties toward the lower expert index (``jax.lax.top_k``) by a stable
descending sort, and the slot ranks come from a stable argsort
(``jnp.argsort``), so two assignments to one expert keep token order.

The dropless path routes as the capacity path (the f32 softmax, its top k
renormalised: the softmax over the top k logits), sorts the T·k
assignments by expert (a stable argsort; the segment ends a prefix sum of
the counts, on the device, never read by the host), gathers the tokens
once and runs each expert's SwiGLU on its segment
(``kernels.ops.moe_experts``: three grouped GEMMs on the card, a loop over
the experts elsewhere), then combines each token's k outputs by its gates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import model_axis_size, shard_spec
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, torch_dtype, wide
from repro_torch.utils.padding import ceil_div


def moe_init(gen: torch.Generator, cfg, device=None):
    """The router in f32; the experts' weights scaled as the reference's
    ``dense_init`` scales them, by their leading axis (E) ** -0.5."""
    dtype = torch_dtype(cfg.dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (d, e), torch.float32, scale=0.02, device=device),
        "w_gate": dense_init(gen, (e, d, f), dtype, device=device),
        "w_up": dense_init(gen, (e, d, f), dtype, device=device),
        "w_down": dense_init(gen, (e, f, d), dtype, device=device),
    }


def moe_capacity(cfg, tokens: int, full_capacity: bool = False) -> int:
    """Slots per expert for ``tokens`` tokens, on the capacity path
    (phi3.5-moe and mixtral: the reference's dispatch, which the port keeps
    for them).  granite-4.0-h-small takes :func:`moe_apply_dropless`, which
    has no capacity."""
    k = cfg.experts_per_token
    if full_capacity:
        return k * tokens
    return int(ceil_div(k * tokens, cfg.num_experts) * cfg.moe_capacity_factor) + 1


def moe_route(params, x, k: int):
    """Router probabilities [T, E] (f32) and the top ``k``: gates [T, k]
    renormalised over the chosen experts, and their indices [T, k], ties
    toward the lower index."""
    probs = torch.softmax(wide(x) @ params["router"], dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def moe_dispatch(expert_idx, num_experts: int, cap: int):
    """Slot assignment of the flattened ``[T·k]`` assignments.

    Returns ``inv`` [E·C] (the token that fills each expert slot, T for an
    empty slot) and ``slot_of_assign`` [T·k] (each assignment's slot, E·C
    where it dropped)."""
    t = expert_idx.shape[0]
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = expert_counts(sorted_e, num_experts)
    offsets = torch.cumsum(counts, 0) - counts          # segment starts
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - offsets[sorted_e]
    keep = rank < cap
    sentinel = num_experts * cap
    slot = torch.where(keep, sorted_e * cap + rank, torch.full_like(rank, sentinel))
    tok_of_sorted = order // expert_idx.shape[1]
    # one row past the buffer takes every dropped write, then is cut off
    inv = torch.full((sentinel + 1,), t, dtype=torch.long, device=flat_e.device)
    inv = inv.index_put((slot,), tok_of_sorted)
    slot_of_assign = torch.empty_like(slot).index_put((order,), slot)
    return inv[:-1], slot_of_assign


def expert_counts(expert_idx, num_experts: int):
    """How many of ``expert_idx``'s entries name each expert: [E] int64,
    ``torch.bincount(expert_idx, minlength=E)``'s integers by a scatter-add
    of ones, which also runs on the meta device (the dry-run's)."""
    flat = expert_idx.reshape(-1).long()
    return torch.zeros(num_experts, dtype=torch.long, device=flat.device).scatter_add(
        0, flat, torch.ones_like(flat))


def moe_apply(params, cfg, x, full_capacity: bool = False):
    """x: [T, d] flattened tokens.  Returns (y [T, d], aux_loss scalar f32).

    The router in f32; the expert products and the combine in the
    parameters' dtype, ``silu`` in f32 and cast back, as the reference."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe_capacity(cfg, t, full_capacity)
    x = shard_spec(x, "dp", None)
    probs, gate_vals, expert_idx = moe_route(params, x, k)

    # load-balance aux loss (Switch eq. 4)
    hits = expert_counts(expert_idx, e).float() / (t * k)
    aux = e * torch.sum(probs.mean(0) * hits)

    inv, slot_of_assign = moe_dispatch(expert_idx, e, cap)
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    z = x_pad[inv].reshape(e, cap, d)

    # expert layout (the reference's specs, whose leading group entry the
    # trailing alignment of resolve_spec drops): experts over the model
    # axis where it divides them (expert parallelism), else d_ff over it
    mdl = model_axis_size()
    ep = e % mdl == 0 and mdl > 1
    if ep:
        z = shard_spec(z, "dp", "model", None, None)
        wg = shard_spec(params["w_gate"], "model", None, None)
        wu = shard_spec(params["w_up"], "model", None, None)
        wd = shard_spec(params["w_down"], "model", None, None)
    else:
        z = shard_spec(z, "dp", None, None, None)
        wg = shard_spec(params["w_gate"], None, None, "model")
        wu = shard_spec(params["w_up"], None, None, "model")
        wd = shard_spec(params["w_down"], None, "model", None)

    g = F.silu(wide(torch.bmm(z, wg))).to(z.dtype)
    u = torch.bmm(z, wu)
    y_ec = torch.bmm(g * u, wd)                                      # [E, C, d]
    y_ec = shard_spec(y_ec, "dp", "model" if ep else None, None, None)

    y_flat = torch.cat([y_ec.reshape(e * cap, d), y_ec.new_zeros((1, d))])
    contrib = y_flat[slot_of_assign].reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", contrib, gate_vals.to(contrib.dtype))
    y = shard_spec(y.to(x.dtype), "dp", None)
    return y, aux


def moe_apply_dense_ref(params, cfg, x):
    """O(T·E) oracle: every expert on every token, weighted by the top-k
    gates.  With capacity for every assignment, ``moe_apply`` must match."""
    t = x.shape[0]
    _, gate_vals, expert_idx = moe_route(params, x, cfg.experts_per_token)
    dense_gates = torch.zeros((t, cfg.num_experts), dtype=torch.float32, device=x.device)
    dense_gates.scatter_(1, expert_idx, gate_vals)
    g = F.silu(torch.einsum("td,edf->tef", x.float(), params["w_gate"].float())).to(x.dtype)
    u = torch.einsum("td,edf->tef", x, params["w_up"])
    y_e = torch.einsum("tef,efd->ted", g * u, params["w_down"])
    return torch.einsum("ted,te->td", y_e.float(), dense_gates).to(x.dtype)


def moe_apply_dropless(params, cfg, x):
    """x: [T, d] flattened tokens.  Returns (y [T, d], aux_loss scalar f32):
    every one of the T·k assignments computed, none dropped.

    The router in f32 as :func:`moe_apply`; the assignments sorted by
    expert (``order``), the tokens gathered once in that order, the
    experts' products over their segments (``kernels.ops.moe_experts``),
    each assignment's output gathered back to its (token, slot) and the k
    of a token summed by its gates in the parameters' dtype."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs, gate_vals, expert_idx = moe_route(params, x, k)
    counts = expert_counts(expert_idx, e)
    aux = e * torch.sum(probs.mean(0) * (counts.float() / (t * k)))
    order = torch.argsort(expert_idx.reshape(-1), stable=True)
    ends = torch.cumsum(counts, 0).to(torch.int32)
    ys = ops.moe_experts(x[order // k], ends, params["w_gate"], params["w_up"],
                         params["w_down"])
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=x.device))
    contrib = ys[rank].reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", contrib, gate_vals.to(contrib.dtype))
    return y.to(x.dtype), aux

"""Model FLOPs of a granite_hybrid configuration (granite-4.0-h-small),
counted from its configuration file as ``modelflops.py`` counts a dense
one: only what the model needs.

Per token, 2 x the parameters of every matrix product it passes through:
each Mamba2 layer's in- and out-projection, each attention layer's q, k,
v and o projections, and in every layer the router, its k routed
experts' three products and the shared expert's three.  Beside them the
SSD's own work in its recurrent form, 4·N·P a token and head (the state's
update b ⊗ x and its read-out Sᵀc, a multiply and an add each), the
attention layers' QKᵀ and PV over the pairs a causal mask keeps, and the
head once a sequence in prefill.  The depthwise conv, the norms and the
gates' elementwise work are left out."""
from __future__ import annotations

from perfbench.modelflops import causal_pairs, head_flops


def layer_counts(c: dict) -> tuple[int, int]:
    """(Mamba2 layers, attention layers)."""
    pattern = c["layer_pattern"]
    return pattern.count("M"), pattern.count("A")


def _d_inner(c: dict) -> int:
    return c["ssm_expand"] * c["d_model"]


def mamba_params(c: dict) -> int:
    d, di, n = c["d_model"], _d_inner(c), c["ssm_state"]
    heads = di // c["ssm_head_dim"]
    return d * (2 * di + 2 * n + heads) + di * d


def attn_params(c: dict) -> int:
    d, hq, hkv, dh = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return d * (hq + 2 * hkv) * dh + hq * dh * d


def ffn_params(c: dict) -> int:
    """The router, the k experts a token is routed to and the shared
    expert: one layer's feed-forward part as a token passes through it."""
    d = c["d_model"]
    return d * c["num_experts"] + c["experts_per_token"] * 3 * d * c["d_ff"] + \
        3 * d * c["shared_d_ff"]


def body_params(c: dict) -> int:
    n_m, n_a = layer_counts(c)
    return n_m * mamba_params(c) + n_a * attn_params(c) + c["num_layers"] * ffn_params(c)


def ssd_flops(c: dict, seq: int) -> int:
    """The SSD of every Mamba2 layer over one sequence."""
    n_m, _ = layer_counts(c)
    heads = _d_inner(c) // c["ssm_head_dim"]
    return 4 * c["ssm_state"] * c["ssm_head_dim"] * heads * seq * n_m


def attention_flops(c: dict, pairs: int) -> int:
    """QKᵀ and PV over ``pairs`` (query, key) pairs in every attention
    layer, for one sequence."""
    _, n_a = layer_counts(c)
    return 4 * c["num_heads"] * c["head_dim"] * pairs * n_a


def prefill_flops(c: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens."""
    per_seq = 2 * body_params(c) * seq + ssd_flops(c, seq) + \
        attention_flops(c, causal_pairs(seq)) + head_flops(c)
    return batch * per_seq

"""Model FLOPs: the work a model needs, counted from its configuration.

Only what the model needs is counted: 2 x the parameters each token
passes through, for every matrix product, causal attention's QK^T and PV
over the pairs a causal mask keeps, and the head once per sequence in
prefill (once per token in training).  A training step is three forward
passes' worth: the forward and the two products of the backward.

``matmul_flops`` counts, for a cross-check, what the port's prefill
multiplies: the head at every position and attention over every pair of
the blockwise plain path's key blocks."""
from __future__ import annotations


def _attn_params(c: dict) -> int:
    d, hq, hkv, dh = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return d * (hq + 2 * hkv) * dh + hq * dh * d


def _ffn_params(c: dict) -> int:
    return (3 if c.get("ffn_type", "swiglu") == "swiglu" else 2) * c["d_model"] * c["d_ff"]


def body_params(c: dict) -> int:
    """Parameters a token passes through in matrix products, the embedding
    lookup and the head left out."""
    if c["arch_type"] != "dense":
        raise ValueError(f"no FLOP count for arch_type {c['arch_type']!r}")
    return c["num_layers"] * (_attn_params(c) + _ffn_params(c))


def head_flops(c: dict) -> int:
    """One position through the head (the logical vocabulary)."""
    return 2 * c["d_model"] * c["vocab_size"]


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_flops(c: dict, pairs: int) -> int:
    """QK^T and PV over ``pairs`` (query, key) pairs, in every layer, for
    one sequence."""
    return 4 * c["num_heads"] * c["head_dim"] * pairs * c["num_layers"]


def prefill_flops(c: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens."""
    per_seq = 2 * body_params(c) * seq + attention_flops(c, causal_pairs(seq)) + head_flops(c)
    return batch * per_seq


def train_flops(c: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step: forward and backward (3x the
    forward), the head at every position."""
    fwd = 2 * body_params(c) * seq + attention_flops(c, causal_pairs(seq)) + head_flops(c) * seq
    return 3 * batch * fwd


def matmul_flops(c: dict, batch: int, seq: int, vocab: int, block_k: int = 512) -> int:
    """Matrix-product FLOPs the port's plain prefill path issues on ``batch``
    x ``seq``: every parameter product, the head at every
    position over the ``vocab`` columns it holds, and QK^T and PV over every
    (query, key) pair of each key block the blockwise path visits."""
    kv_blocks = -(-seq // block_k)
    pairs = seq * kv_blocks * block_k
    return batch * (2 * body_params(c) * seq + attention_flops(c, pairs)
                    + 2 * c["d_model"] * vocab * seq)

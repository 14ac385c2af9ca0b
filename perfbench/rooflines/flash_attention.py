"""Causal prefill attention (``kernels/csrc/flash_attention.cu``'s
forward), one call: q [B, Hq, S, Dh], k and v [B, Hkv, S, Dh] read once,
out [B, Hq, S, Dh] written once; QKᵀ and PV over the pairs the causal
mask keeps."""
from perfbench.modelflops import causal_pairs
from perfbench.rooflines.common import bound

COUNTER = "flash_attention"
KERNELS = ("flash_attention_bf16_kernel", "flash_attention_f32_kernel")


def bound_s(c: dict, batch: int, seq: int) -> tuple[float, str]:
    dt_, hq, hkv, dh = c["dtype"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    flops = 4 * dh * batch * hq * causal_pairs(seq)
    q, kv = (batch, hq, seq, dh), (batch, hkv, seq, dh)
    return bound([(q, dt_), (kv, dt_), (kv, dt_), (q, dt_)], flops, dt_)

"""Causal attention's backward (``flash_attention.cu``'s delta, dk/dv and
dq kernels), one call: q, k, v, out, dout and the forward's row
logsumexp (f32) read once, dq, dk and dv written once; S, dP, dV, dK and
dQ over the pairs the causal mask keeps."""
from perfbench.modelflops import causal_pairs
from perfbench.rooflines.common import bound

COUNTER = "flash_attention_bwd"
KERNELS = ("flash_attention_bwd_delta_kernel", "flash_attention_bwd_dkdv_bf16_kernel",
           "flash_attention_bwd_dq_bf16_kernel", "flash_attention_bwd_dkdv_kernel",
           "flash_attention_bwd_dq_kernel")


def bound_s(c: dict, batch: int, seq: int) -> tuple[float, str]:
    dt_, hq, hkv, dh = c["dtype"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    flops = 10 * dh * batch * hq * causal_pairs(seq)
    q, kv = (batch, hq, seq, dh), (batch, hkv, seq, dh)
    tensors = [(q, dt_), (kv, dt_), (kv, dt_), (q, dt_), (q, dt_), ((batch, hq, seq), "float32"),
               (q, dt_), (kv, dt_), (kv, dt_)]
    return bound(tensors, flops, dt_)

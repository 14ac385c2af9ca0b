"""The Mamba2 SSD scan (``kernels/csrc/ssd_scan.cu``'s forward), one call:
x [B, S, H, P] and y [B, S, H, P] in the configuration's dtype, dt
[B, S, H] f32, b and c [B, S, N] read or written once (a and d_skip [H]
f32 beside them); the chunked form's products at the kernel's chunk of
64, per (sequence, head, chunk) of Q steps: C·Bᵀ and W·x over the Q(Q+1)/2
pairs a causal mask keeps, the state's read-out C·S and its update Bᵀ·x
over Q x N x P each."""
from perfbench.rooflines.common import bound

COUNTER = "ssd_scan"
KERNELS = ("ssd_scan_bf16_kernel", "ssd_scan_f32_kernel")
CHUNK = 64


def bound_s(c: dict, batch: int, seq: int) -> tuple[float, str]:
    dt_, n, p = c["dtype"], c["ssm_state"], c["ssm_head_dim"]
    h = c["ssm_expand"] * c["d_model"] // p
    chunks = -(-seq // CHUNK)
    pairs = CHUNK * (CHUNK + 1) // 2
    flops = batch * h * chunks * (2 * pairs * (n + p) + 4 * CHUNK * n * p)
    x, bc = (batch, seq, h, p), (batch, seq, n)
    tensors = [(x, dt_), (x, dt_), ((batch, seq, h), "float32"), (bc, dt_), (bc, dt_),
               ((h,), "float32"), ((h,), "float32")]
    return bound(tensors, flops, dt_)

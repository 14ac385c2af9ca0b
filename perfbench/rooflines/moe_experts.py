"""The MoE's grouped expert products (``kernels/moe_experts.py``: gate, up
and down, three grouped GEMMs over the experts' segments), one call, of
one layer at the run's shape: the experts' weights (3 x [E, d, f]) read
once, the gathered tokens [T·k, d] read once and the experts' outputs
[T·k, d] written once; 2 · T·k · 3 · d · f operations.

``KERNELS`` are substrings of the names the trace gives PyTorch's grouped
GEMM (CUTLASS's, named by its mangled symbol) and the kernel that lays out
its problem sizes; the metric ``moe_experts_roofline`` matches them."""
from perfbench.rooflines.common import bound

COUNTER = "moe_experts"
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def bound_s(c: dict, batch: int, seq: int) -> tuple[float, str]:
    dt_, d, f, e = c["dtype"], c["d_model"], c["d_ff"], c["num_experts"]
    rows = batch * seq * c["experts_per_token"]
    flops = 2 * rows * 3 * d * f
    tensors = [((e, d, f), dt_), ((e, d, f), dt_), ((e, f, d), dt_), ((rows, d), dt_),
               ((rows, d), dt_)]
    return bound(tensors, flops, dt_)

"""The MoE's grouped expert products' share of their roofline: the bound of
one call (one layer's three products) at the run's shape
(``rooflines/moe_experts.py``) over the call's device time in the profiled
calls (each of its kernels' median launch, by name, times its launches
per call), in percent.  The trace names PyTorch's CUTLASS grouped GEMM by
its mangled symbol, which the harness's matcher of a function's name does
not take, so its kernels are matched here by the substrings the roofline
lists.  ``None`` where the run launched none of them."""
import statistics

from perfbench.harness import load_module


def read(run):
    if run.profile is None:
        return None
    rl = load_module("rooflines", "moe_experts")
    calls = run.profile.launches.get(rl.COUNTER, 0)
    times: dict = {}
    for name, start, end in run.profile.kernels:
        if any(k in name for k in rl.KERNELS):
            times.setdefault(name, []).append((end - start) * 1e-6)
    if not calls or not times:
        return None
    per_call = sum(statistics.median(t) * len(t) / calls for t in times.values())
    bound, _ = rl.bound_s(run.c, *run.shape)
    return 100.0 * bound / per_call

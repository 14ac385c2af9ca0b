"""The benchmark's general machinery: a cell's files, one run's record,
the reading of a profiler trace, and the run itself.

A run: set-up (weights, traffic, warm-up of every shape the cell uses),
the measured window of ``--seconds`` seconds, with ``--trace 1`` a few
more steps under ``torch.profiler``, the peak memory, the program's state
freed, then the comparison with the plain reference that decides
``correct``.  The driver named in the cell's workload file
(``drivers/<driver>.py``) supplies set-up, window, profiled steps and
check; per-layer metrics are read by ``metrics/<name>.py``, each from
this record."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def load_workload(name: str) -> dict:
    wl = load_json(f"workloads/{name}.json")
    wl.setdefault("name", name)
    return wl


def load_config(name: str) -> dict:
    return load_json(f"configs/{name}.json")


#: the port's names of the published keys a configuration may cut, and
#: only by listing them under ``reduced``: the depth
CUTS = {"num_layers": "num_hidden_layers"}


def arch_config(c: dict):
    """The port's ``ArchConfig`` of the configuration file ``c``: its
    registry entry, with the depth the file states where it lists the cut;
    raise where another size of the file and the entry differ, so a run
    never measures another model than the file states."""
    from repro_torch.configs import get_config

    cuts = {k: c[k] for k, key in CUTS.items() if key in c["reduced"]}
    cfg = dataclasses.replace(get_config(c["registry"]), **cuts)
    sizes = {f.name for f in dataclasses.fields(cfg)} - {"name", "source"}
    for key, value in c.items():
        if key in sizes and getattr(cfg, key) != value:
            raise ValueError(f"{c['name']}: {key} is {getattr(cfg, key)!r} in the port's "
                             f"registry and {value!r} in the configuration file")
    return cfg


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` (a driver, roofline or metric), found by
    its name as ``BENCHMARK.json`` gives it."""
    path = ROOT / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(REPO)}")
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quantile(values, q: int, n: int = 100) -> float:
    """The q-th of n quantiles (``statistics.quantiles``, exclusive)."""
    vals = sorted(values)
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=n)[q - 1])


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """Device operations of the profiled steps, on the profiler's clock
    (microseconds): ``kernels`` [(name, start, end)], memory copies and sets
    in ``others``, host operations in ``host`` [(name, start, end)];
    ``launches`` the port's own counter (``kernels/_build.LAUNCHES``) over
    the same steps; ``steps`` how many."""
    kernels: list
    others: list
    host: list
    launches: dict
    steps: int

    @property
    def device(self):
        return self.kernels + self.others

    def window(self) -> tuple[float, float]:
        spans = self.device + self.host
        return min(s for _, s, _ in spans), max(e for _, _, e in spans)

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, merged."""
        merged = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def window_s(self) -> float:
        lo, hi = self.window()
        return (hi - lo) * 1e-6

    def kernel_times(self, functions) -> dict:
        """{kernel name: [durations in s]} of the kernels whose function is
        one of ``functions`` (the trace names it with its return type,
        namespace and template arguments:
        ``void (anonymous namespace)::flash_attention_bf16_kernel<...>(...)``)."""
        pattern = re.compile(r"(?:^|[\s:])(?:%s)[<(]" % "|".join(map(re.escape, functions)))
        out: dict = {}
        for name, s, e in self.kernels:
            if pattern.search(name):
                out.setdefault(name, []).append((e - s) * 1e-6)
        return out

    def top_ops(self, n: int = 10) -> list:
        per: dict = {}
        for name, s, e in self.device:
            per[name] = per.get(name, 0.0) + (e - s) * 1e-6
        return [[k[:96], v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches with nothing on the device, each
        labelled by the innermost host operation running at its middle."""
        lo, hi = self.window()
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            covering = [h for h in self.host if h[1] <= mid <= h[2]]
            label = max(covering, key=lambda h: h[1])[0] if covering else "host (no traced op)"
            out.append([label[:96], (e - s) * 1e-6])
        return out


def profile(fn, steps: int, device) -> Trace:
    """Run ``fn()`` (``steps`` steps of the cell, ending in a synchronize)
    under ``torch.profiler`` and read its trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import _build

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _build.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    kernels, others, host = [], [], []
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            low = ev.name.lower()
            (others if low.startswith(("memcpy", "memset")) else kernels).append(span)
        else:
            host.append(span)
    return Trace(kernels, others, host, launches, steps)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """One run of a cell and everything its metrics read."""
    wl: dict
    c: dict                      # the configuration file
    cfg: object                  # the port's ArchConfig
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float               # process start on the host clock
    phase: str = ""
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0               # calls completed in the window
    tokens: int = 0              # tokens those calls processed
    call_s: list = field(default_factory=list)      # host seconds per call, to its result
    dispatch_s: list = field(default_factory=list)  # host seconds per call, to its return
    flops: float = 0.0           # model FLOPs of the window's work
    shape: tuple = ()            # the kernels' shape arguments (batch, seq)
    profile: Trace | None = None
    memory_peak: int = 0
    checks: dict = field(default_factory=dict)
    check_s: float = 0.0
    marks: list = field(default_factory=list)       # (what, host seconds since start)

    def mark(self, what: str) -> None:
        self.marks.append((what, time.perf_counter() - self.t_start))

    # -- readers the metric files call; None where this run has nothing to read
    def dispatch_ms(self, phase: str):
        if self.phase != phase or not self.dispatch_s:
            return None
        return statistics.median(self.dispatch_s) * 1e3

    def launches(self, phase: str):
        if self.phase != phase or self.profile is None:
            return None
        return len(self.profile.kernels) / self.profile.steps

    def idle_pct(self, phase: str):
        if self.phase != phase or self.profile is None:
            return None
        return 100.0 * (1.0 - self.profile.busy_s() / self.profile.window_s())

    def mfu_pct(self, phase: str):
        from perfbench.peaks import BF16_FLOP_PER_S

        if self.phase != phase or not self.flops or self.window_s <= 0:
            return None
        return 100.0 * self.flops / self.window_s / BF16_FLOP_PER_S

    def roofline_pct(self, kernel: str):
        """The kernel's bound (``rooflines/<kernel>.py``, at this run's shape)
        over its device time per call: the median of each of its kernels'
        launches, times their launches per call, summed."""
        if self.profile is None:
            return None
        rl = load_module("rooflines", kernel)
        calls = self.profile.launches.get(rl.COUNTER, 0)
        times = self.profile.kernel_times(rl.KERNELS)
        if not calls or not times:
            return None
        per_call = sum(statistics.median(t) * len(t) / calls for t in times.values())
        bound, _ = rl.bound_s(self.c, *self.shape)
        return 100.0 * bound / per_call


def metric_names(wl_name: str, kind: str) -> list:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``) in
    ``BENCHMARK.json``: those that list the cell, or list no cells."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    return [m for m in manifest[kind] if wl_name in m.get("workloads", [wl_name])]


def end_to_end(run: Run, metrics: list) -> dict:
    values = {
        "setup_s": run.setup_s,
        "prefill_tok_s": run.tokens / run.window_s if run.phase == "prefill" else None,
        "ttft_p95_ms": quantile(run.call_s, 95) * 1e3
        if run.phase == "prefill" and run.call_s else None,
        "train_tok_s": run.tokens / run.window_s if run.phase == "train" else None,
    }
    out = {}
    for m in metrics:
        v = values.get(m["name"])
        if v is None:
            raise RuntimeError(f"{run.wl['name']}: no reading of {m['name']}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def per_layer(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        v = load_module("metrics", m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(wl: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             c: dict | None = None, cfg=None) -> dict:
    """One run of the cell ``wl``; returns the result line's object.  ``c``
    and ``cfg`` default to the cell's configuration file and the port's
    entry for it (a test hands a smaller one)."""
    import torch

    c = c if c is not None else load_config(wl["config"])
    cfg = cfg if cfg is not None else arch_config(c)
    run = Run(wl, c, cfg, seed, seconds, trace, torch.device(device), t_start)
    driver = load_module("drivers", wl["driver"]).Driver(run)
    run.phase = driver.phase
    run.mark("imports")
    import repro_torch.models  # noqa: F401  (the program)
    run.mark("program")
    if run.device.type == "cuda":
        torch.zeros(1, device=run.device)
        torch.cuda.synchronize(run.device)
        run.mark("context")
    driver.setup()
    run.setup_s = time.perf_counter() - t_start
    driver.window(seconds, with_flops=trace)
    if trace:
        run.profile = profile(lambda: driver.steps(wl["profile_steps"]), wl["profile_steps"],
                              run.device)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        run.memory_peak = int(torch.cuda.max_memory_allocated(run.device))
    driver.free()
    t_check = time.perf_counter()
    run.checks = driver.check()
    run.check_s = time.perf_counter() - t_check
    metrics = metric_names(wl["name"], "per_layer" if trace else "end_to_end")
    values = per_layer(run, metrics) if trace else end_to_end(run, metrics)
    limits = wl["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in run.checks.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values()) and \
        set(checks) == set(limits)
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
           else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak}
    result = {"correct": bool(correct), "attempted": driver.attempted, "failed": 0,
              "metrics": values, "device": dev}
    if trace:
        dev["busy_s"] = run.profile.busy_s()
        dev["window_s"] = run.profile.window_s()
        result["breakdown"] = {"device_ops": run.profile.top_ops(),
                               "idle_gaps": run.profile.idle_gaps()}
    result["checks"] = checks
    marks = ", ".join(f"{what} {t:.3f}" for what, t in run.marks)
    print(f"{wl['name']} seed {seed}: set-up {run.setup_s:.3f} s ({marks}), window "
          f"{run.window_s:.3f} s ({run.units} calls), check {run.check_s:.3f} s", file=sys.stderr)
    return result


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)

"""``spans.py`` and the metrics read from the program's spans.

A traced run of each cell at a tiny size on the CPU reads every one of
its span metrics, ``syncs.*`` 0 (a CPU run makes no CUDA runtime call).
Synthetic traces check the rest: no mark reads ``None``; a mark left
unmatched, marks that cross or calls other than the profiled steps
raise; each synchronizing call is counted and an asynchronous copy is
not; device idle is counted inside the calls alone."""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spans
from perfbench.harness import Trace

TINY = {
    "granite-3-2b.prefill-4x2k": dict(batch=2, prompt_len=32, max_len=32, pool=3, warmup=1,
                                      check={"sample": 2, "block": 2, "positions": 2}),
    "granite-3-2b-pp2.train-4x512": dict(batch=2, seq=16, pool=6),
}
METRICS = {
    "granite-3-2b.prefill-4x2k": ["host_ms.prefill.attention", "host_ms.prefill.ffn",
                                  "host_ms.prefill.cache", "syncs.prefill",
                                  "program_idle_ms.prefill"],
    "granite-3-2b-pp2.train-4x512": ["host_ms.train.forward", "host_ms.train.backward",
                                     "host_ms.train.optimizer", "syncs.train",
                                     "program_idle_ms.train"],
}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tiny(cell: str):
    """The cell's workload at a tiny size, and its one-layer reduced
    configuration (``c``, ``cfg``)."""
    from repro_torch.configs import get_config

    wl = harness.load_workload(cell)
    wl.update(TINY[cell])
    registry = harness.load_config(wl["config"])["registry"]
    cfg = dataclasses.replace(get_config(registry).reduced(), num_layers=1)
    return wl, dataclasses.asdict(cfg), cfg


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_traced_run_reads_every_span_metric(cell):
    wl, c, cfg = _tiny(cell)
    res = harness.run_cell(wl, 2**33 + 7, 0.05, True, "cpu", time.perf_counter(), c=c, cfg=cfg)
    got = res["metrics"]
    assert set(METRICS[cell]) <= set(got)
    assert [m["name"] for m in harness.metric_names(cell, "per_layer")
            if m["source"] == "program_span"] == METRICS[cell]
    for name in METRICS[cell]:
        assert isinstance(got[name]["value"], float), name
        assert got[name]["value"] == 0.0 if name.startswith("syncs.") else \
            got[name]["value"] > 0.0, (name, got[name])


def _run(host, kernels=(), steps=1, phase="prefill"):
    return SimpleNamespace(phase=phase,
                           profile=Trace(list(kernels), [], list(host), {}, steps))


def _marks(*items):
    """(name, time) pairs: ">x" opens the span x, "<x" closes it."""
    return [(("repro" + n), t, t) for n, t in items]


CALL = _marks((">prefill", 0), (">attention", 10), ("<attention", 40), (">ffn", 50),
              ("<ffn", 70), (">cache", 80), ("<cache", 90), ("<prefill", 100))


@pytest.mark.parametrize("metric", sorted(m for ms in METRICS.values() for m in ms))
def test_no_marks_read_none(metric):
    """The parent's program writes no mark: every span metric reads
    ``None``, and the result line leaves it out."""
    phase = "prefill" if ".prefill" in metric else "train"
    run = _run([("aten::mm", 0, 5), ("cudaStreamSynchronize", 1, 2)],
               [("k", 0, 5)], phase=phase)
    assert harness.load_module("metrics", metric).read(run) is None


def test_a_call_reads_its_spans():
    run = _run(CALL + [("aten::mm", 12, 20)])
    assert spans.host_ms(run, "prefill", "attention") == pytest.approx(0.030)
    assert spans.host_ms(run, "prefill", "ffn") == pytest.approx(0.020)
    assert spans.host_ms(run, "prefill", "cache") == pytest.approx(0.010)
    assert spans.host_ms(run, "prefill", "forward") is None
    assert spans.host_ms(run, "train", "attention") is None      # another phase
    tree = spans.parse(run.profile)
    assert [(s.name, s.start, s.end, s.parent and s.parent.name) for s in tree] == [
        ("prefill", 0, 100, None), ("attention", 10, 40, "prefill"),
        ("ffn", 50, 70, "prefill"), ("cache", 80, 90, "prefill")]


@pytest.mark.parametrize("marks", [
    pytest.param(_marks((">prefill", 0), (">ffn", 10), ("<prefill", 20)), id="unclosed"),
    pytest.param(_marks((">prefill", 0), ("<ffn", 10), ("<prefill", 20)), id="unopened"),
    pytest.param(_marks((">prefill", 0), (">ffn", 10), ("<prefill", 20), ("<ffn", 30)),
                 id="crossing"),
    pytest.param(CALL + [(n, t + 200, e + 200) for n, t, e in CALL], id="two-calls"),
    pytest.param(_marks((">attention", 0), ("<attention", 10)), id="no-call"),
])
def test_malformed_marks_raise(marks):
    with pytest.raises(ValueError):
        spans.parse(Trace([], [], marks, {}, 1))


def test_marks_at_one_instant():
    """A span that ends where another begins, and two that end together."""
    marks = _marks((">prefill", 0), (">attention", 1), ("<attention", 5), (">ffn", 5),
                   ("<ffn", 9), ("<prefill", 9))
    tree = spans.parse(Trace([], [], marks[::-1], {}, 1))
    assert [(s.name, s.start, s.end) for s in tree] == [
        ("prefill", 0, 9), ("attention", 1, 5), ("ffn", 5, 9)]


@pytest.mark.parametrize("name", spans.SYNCS)
def test_each_sync_is_counted(name):
    host = CALL + [(name, 20, 25), (name, 95, 99), (name, 150, 160),
                   ("cudaMemcpyAsync", 30, 31), ("cudaLaunchKernel", 31, 32)]
    assert spans.syncs(_run(host), "prefill") == 2.0
    assert spans.syncs(_run(host), "train") is None              # another phase


def test_an_async_copy_is_not_a_sync():
    host = CALL + [("cudaMemcpyAsync", 20, 25), ("cudaMemsetAsync", 26, 27),
                   ("cudaStreamWaitEvent", 28, 29)]
    assert spans.syncs(_run(host), "prefill") == 0.0


def test_idle_counts_only_gaps_inside_calls():
    second = [(n, t + 200, e + 200) for n, t, e in CALL]
    kernels = [("k", -50, 30), ("k", 60, 120), ("k", 120, 150), ("k", 230, 280)]
    run = _run(CALL + second, kernels, steps=2)
    # inside [0, 100]: idle 30-60; inside [200, 300]: idle 200-230 and 280-300
    assert spans.program_idle_ms(run, "prefill") == pytest.approx((30 + 30 + 20) * 1e-3 / 2)
    # the gap 150-200 lies between the calls, and is left out
    assert spans.host_ms(run, "prefill", "attention") == pytest.approx(0.030)


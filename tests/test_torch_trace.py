"""``repro_torch.utils.trace``: the port's spans.

With no profiler recording, ``span`` calls no ``record_function`` and
returns one shared no-op context.  Under ``torch.profiler`` it leaves the
documented zero-width marks (``repro>NAME``, ``repro<NAME``), host events
alone; a granite prefill and a ``make_train_step`` step leave exactly the
documented spans, nested as documented, and compute the same bits as with
no profiler.  The flag the writer checks is torch's private
``torch.autograd.profiler._is_profiler_enabled``: a torch without it fails
here instead of tracing nothing."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as autograd_profiler

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, prefill
from repro_torch.train.optim import adamw
from repro_torch.utils import trace


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(layers: int):
    return dataclasses.replace(get_config("granite-3-2b").reduced(), num_layers=layers)


def _params(cfg):
    return init_params(torch.Generator().manual_seed(5), cfg, device="cpu")


def _tokens(cfg, b=2, s=16):
    return torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(6))


def _prefill(cfg, params):
    with torch.no_grad():
        return prefill(params, cfg, _tokens(cfg), 24)


def _step(cfg, params):
    rows = _tokens(cfg, s=17)
    step = make_train_step(cfg, use_remat=False)
    return step(params, adamw(3e-4)[0](params), {"tokens": rows[:, :-1], "labels": rows[:, 1:]})


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled
        out = fn()
    assert not autograd_profiler._is_profiler_enabled
    return out, [ev for ev in prof.events() if ev.name.startswith(("repro>", "repro<"))]


def _tree(marks):
    """The marks, in time order, paired as brackets: [(name, [children])]."""
    root, stack = [], []
    for ev in sorted(marks, key=lambda ev: ev.time_range.start):
        kind, name = ev.name[:6], ev.name[6:]
        if kind == trace.ENTER:
            node = (name, [])
            (stack[-1][1] if stack else root).append(node)
            stack.append(node)
        else:
            assert stack and stack[-1][0] == name, (ev.name, stack)
            stack.pop()
    assert not stack
    return root


def test_the_flag_is_torchs():
    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(trace.span("x"), trace._Marks)
    assert trace.span("x") is trace.span("y") is trace._OFF


def test_off_calls_no_record_function(monkeypatch):
    calls = []
    real = autograd_profiler.record_function

    def counting(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", counting)
    cfg = _cfg(1)
    params = _params(cfg)
    _prefill(cfg, params)
    _step(cfg, params)
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("x"):
            pass
    assert calls == [("repro>x",), ("repro<x",)]


def test_a_mark_is_zero_width_and_on_the_host():
    def body():
        with trace.span("outer"):
            torch.ones(8).sum()
            with trace.span("inner"):
                torch.ones(8).sum()

    _, marks = _profiled(body)
    assert [ev.name for ev in sorted(marks, key=lambda ev: ev.time_range.start)] == [
        "repro>outer", "repro>inner", "repro<inner", "repro<outer"]
    assert all(ev.device_type != DeviceType.CUDA for ev in marks)
    assert all(not ev.cpu_children for ev in marks)
    assert _tree(marks) == [("outer", [("inner", [])])]


@pytest.mark.parametrize("layers", [1, 2])
def test_prefill_spans(layers):
    cfg = _cfg(layers)
    params = _params(cfg)
    want = _prefill(cfg, params)
    got, marks = _profiled(lambda: _prefill(cfg, params))
    assert all(ev.device_type != DeviceType.CUDA for ev in marks)
    assert len(marks) == 2 * (2 + 2 * layers)
    assert _tree(marks) == [("prefill", [("attention", []), ("ffn", [])] * layers
                             + [("cache", [])])]
    for a, b in zip(_leaves(want), _leaves(got), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layers", [1, 2])
def test_train_step_spans(layers):
    cfg = _cfg(layers)
    params = _params(cfg)
    want = _step(cfg, params)
    got, marks = _profiled(lambda: _step(cfg, params))
    assert all(ev.device_type != DeviceType.CUDA for ev in marks)
    assert _tree(marks) == [("train_step", [
        ("forward", [("attention", []), ("ffn", [])] * layers),
        ("backward", []),
        ("optimizer", []),
    ])]
    for a, b in zip(_leaves(want), _leaves(got), strict=True):
        assert torch.equal(a, b)

"""A whole run of each cell at a tiny size on the CPU, the look for a card
skipped, with the timed path broken underneath: ``correct`` has to come
out false.  The faults a cell can have: a token altered where it is
produced, and a cache left without a layer's keys (prefill); a step that
returns its state unchanged, and half of the batch left out with the mean
taken over the rest (training).  The exchange between chips does not
exist on one chip.  Beside them, the same runs unbroken come out
correct."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from perfbench import control, harness

TINY = {
    "granite-3-2b.prefill-4x2k": dict(batch=2, prompt_len=64, max_len=64, pool=3, warmup=1,
                                      check={"sample": 6, "block": 3, "positions": 3}),
    "granite-3-2b-pp2.train-4x512": dict(batch=2, seq=32, pool=6),
}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_run(cell: str) -> dict:
    """The cell at its reduced configuration (f32, so that a sound run reads
    far under every limit), a few calls long."""
    from repro_torch.configs import get_config

    wl = harness.load_workload(cell)
    wl.update(TINY[cell])
    cfg = get_config(harness.load_config(wl["config"])["registry"]).reduced()
    return harness.run_cell(wl, 2**33 + 5, 0.05, False, "cpu", time.perf_counter(),
                            c=dataclasses.asdict(cfg), cfg=cfg)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    res = tiny_run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [control.altered, control.cache_altered])
def test_prefill_fault_is_caught(fault, monkeypatch):
    import repro_torch.models as models

    monkeypatch.setattr(models, "prefill", fault(models.prefill))
    assert not tiny_run("granite-3-2b.prefill-4x2k")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_fault_is_caught(fault, monkeypatch):
    import repro_torch.launch.steps as steps

    broken = control.train_fault(steps.make_train_step, fault)
    monkeypatch.setattr(steps, "make_train_step", broken)
    assert not tiny_run("granite-3-2b-pp2.train-4x512")["correct"]

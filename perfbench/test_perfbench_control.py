"""The control that sets each limit's upper end, at a size a test run holds:
the plain reference with every matrix product's operands rounded to
float8 e4m3 (the precision below the configuration's bf16), put in the
program's place and read as the program is.  At the cells' reduced
configuration on the CPU (the program in bf16, as on the card) it reads
several times what the program reads, as on the card at full size
(``PERF.md`` gives those readings and the limits set from them)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import control, harness

SMALL = {
    "granite-3-2b.prefill-4x2k": dict(batch=2, prompt_len=64, max_len=64, pool=8, warmup=1,
                                      check={"sample": 16, "block": 4, "positions": 4}),
    "granite-3-2b-pp2.train-4x512": dict(batch=2, seq=64, pool=6),
}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_reads_far_above_the_program(cell):
    from repro_torch.configs import get_config

    wl = harness.load_workload(cell)
    wl.update(SMALL[cell])
    registry = harness.load_config(wl["config"])["registry"]
    cfg = dataclasses.replace(get_config(registry).reduced(), dtype="bfloat16")
    got = control.readings(wl, 2**32 + 9, 0.5, True, "cpu", dataclasses.asdict(cfg), cfg)
    program, low = got["program"], got["control"]
    assert set(program) == set(low) == set(wl["limits"])
    # the control fails by at least one number: three times the program's
    # reading, and more than the rounding of bf16 alone could give
    assert any(low[k] >= 3 * program[k] and low[k] > 1e-3 for k in program), got

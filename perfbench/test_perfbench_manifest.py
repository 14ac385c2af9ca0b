"""``BENCHMARK.json`` and the files it names: they load, keep the
manifest's rules of names, units and lengths, every per-layer metric's
``moves`` is reported by each of its cells, the harness and the program
it runs load no JAX module and the reference nothing of the program, and
``run.py`` without a card exits non-zero with no result."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import arch_config, load_config, load_module, load_workload

REPO = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(line(w) for w in MANIFEST["command"])
    assert all((REPO / p).is_dir() for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line(w["why"]) and NAME.fullmatch(w["traffic"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    per_layer = MANIFEST["per_layer"]
    for m in per_layer:
        assert m["moves"] in E2E
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and reports(cell, E2E[m["moves"]]), (m["name"], cell)
    for cell in CELLS:
        e2e = [n for n, m in E2E.items() if reports(cell, m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(cell, m) for m in per_layer)
    assert {c["name"] for c in MANIFEST["configs"]} == {w["config"] for w in MANIFEST["workloads"]}
    # the cells' per-layer metrics of one layer share its name
    layers = {m["layer"] for m in per_layer}
    assert layers == {"serve entry", "train entry", "model step", "kernels", "device"}


def test_runtime_fits_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    wl = load_workload(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key]
    assert hasattr(load_module("drivers", wl["driver"]), "Driver")
    for m in MANIFEST["per_layer"]:
        if reports(cell, m):
            assert callable(load_module("metrics", m["name"]).read)
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_files_are_the_ports_entries(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    c = load_config(config)
    assert entry["file"] == f"perfbench/configs/{config}.json"
    assert c["source"] == entry["source"] and c["reduced"] == entry["reduced"]
    cfg = arch_config(c)          # raises where a size differs
    assert cfg.num_layers == c["num_layers"] and cfg.d_model == c["d_model"]


def _fresh(code: str) -> list:
    """The top-level modules a fresh interpreter holds after ``code``."""
    prog = (f"import sys; sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n{code}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_reference_imports_nothing_of_the_program():
    mods = _fresh("import perfbench.reference.model, perfbench.reference.train")
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & set(mods)


def test_a_run_loads_no_jax():
    """A whole run at a tiny size on the CPU: the harness, the program and
    the reference load neither JAX nor the JAX package."""
    code = """
import dataclasses, time, torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from perfbench import harness
wl = harness.load_workload("granite-3-2b.prefill-4x2k")
wl.update(batch=1, prompt_len=16, max_len=16, pool=2, warmup=1,
          check={"sample": 1, "block": 1, "positions": 2})
cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_layers=1)
res = harness.run_cell(wl, 1, 0.05, False, "cpu", time.perf_counter(),
                       c=dataclasses.asdict(cfg), cfg=cfg)
assert res["correct"], res
"""
    mods = _fresh(code)
    assert "repro_torch" in mods
    assert not {"jax", "jaxlib", "flax", "repro"} & set(mods)


def _run_py(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=cwd, env=env)


def test_run_without_a_card_prints_no_result():
    out = _run_py(REPO)
    assert out.returncode != 0
    assert '"metrics"' not in out.stdout and not out.stdout.strip()


def test_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()

"""Dry-run driver: every (architecture x input shape x mesh) at full width
and depth, on meta tensors over a fake device mesh.

The reference's ``repro.launch.dryrun``, with no compiler: for each
combination it builds the sharded step (``launch.steps.make_step``) with
meta ``DTensor`` arguments over a ``DeviceMesh`` of 256 or 512 ranks on a
fake process group (``launch.mesh``), runs it once while
``launch.roofline.StepCounter`` counts its FLOPs, bytes and collectives,
and writes a roofline record with the H100's constants under
``experiments/dryrun_torch/``.  A failure here is a sharding bug in the
port (or an op ``DTensor`` has no rule for).  Nothing is allocated on any
device.

The counts are exact: each op runs at its full shapes.  With extrapolation
on (the default, as the reference) the record's counts come instead from
1-unit and 2-unit variants (``ArchConfig.unit_dims``/``with_unit_counts``)
extended affinely to the real depth, the reference's method, which the
tests hold equal to the full-depth count.

Importing this module starts no process group and sets no environment
variable; the fake group lives only inside :func:`run_one`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 records
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback

import torch

from repro_torch.configs import CLI_ALIASES, get_config
from repro_torch.launch.mesh import production_mesh
from repro_torch.launch.roofline import StepCounter, analyze
from repro_torch.launch.specs import supports_shape
from repro_torch.launch.steps import make_step, resolve_serve_mode
from repro_torch.models.config import INPUT_SHAPES, InputShape
from repro_torch.params import tree_leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _local_bytes(tree) -> int:
    """Bytes of one device's share of ``tree``'s tensors: a ``DTensor``'s
    local shard, a plain tensor whole."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            total += local.numel() * local.element_size()
    return total


def _memory_stats(args, out, donated) -> dict:
    """Per-device argument, output and alias (donated argument) bytes, from
    the shapes of the local shards.  The reference's XLA analysis also
    gives temporaries; on meta tensors they are not measured, so there is
    no such entry."""
    return {
        "argument_size_in_bytes": _local_bytes(list(args)),
        "output_size_in_bytes": _local_bytes(out),
        "alias_size_in_bytes": _local_bytes([args[i] for i in donated]),
    }


def _step_kwargs(shape, serve_mode) -> dict:
    return {} if shape.kind == "train" else {"mode": serve_mode}


def count_step(cfg, mesh, shape, **kw) -> tuple[dict, dict, float]:
    """Build ``make_step(cfg, mesh, shape, **kw)`` and run it once on its
    abstract arguments under the counters: (cost, memory stats, seconds)."""
    t0 = time.perf_counter()
    fn, args = make_step(cfg, mesh, shape, **kw)
    with StepCounter() as counter:
        out = fn(*args)
    return counter.cost(), _memory_stats(args, out, fn.donated), time.perf_counter() - t0


def _lin_combine(base, deltas, weights):
    """base + sum_g weights[g] * deltas[g] applied to the cost dicts."""
    out = {
        "flops": base["flops"],
        "bytes": base["bytes"],
        "coll": {
            "bytes": dict(base["coll"]["bytes"]),
            "counts": dict(base["coll"]["counts"]),
        },
    }
    for g, d in deltas.items():
        w = weights[g]
        out["flops"] += w * d["flops"]
        out["bytes"] += w * d["bytes"]
        for k in out["coll"]["bytes"]:
            out["coll"]["bytes"][k] += w * d["coll"]["bytes"][k]
            out["coll"]["counts"][k] += w * d["coll"]["counts"][k]
    return out


def _extrapolated_cost(shape, mesh, cfg, *, serve_mode):
    """The reference's cost accounting: run 1-unit and 2-unit variants and
    extend affinely to the real unit counts (integers throughout, so the
    result is exact where the cost is affine in the depth)."""
    dims = cfg.unit_dims()
    base_counts = {name: 1 for name, _ in dims}
    kw = _step_kwargs(shape, serve_mode)

    def count(counts):
        return count_step(cfg.with_unit_counts(counts), mesh, shape, **kw)[0]

    base = count(base_counts)
    deltas, weights = {}, {}
    for name, real in dims:
        counts = dict(base_counts)
        counts[name] = 2
        var = count(counts)
        keys = set(var["coll"]["bytes"]) | set(base["coll"]["bytes"])
        deltas[name] = {
            "flops": var["flops"] - base["flops"],
            "bytes": var["bytes"] - base["bytes"],
            "coll": {
                "bytes": {k: var["coll"]["bytes"].get(k, 0) - base["coll"]["bytes"].get(k, 0)
                          for k in keys},
                "counts": {k: var["coll"]["counts"].get(k, 0)
                           - base["coll"]["counts"].get(k, 0) for k in keys},
            },
        }
        for k in keys:
            base["coll"]["bytes"].setdefault(k, 0)
            base["coll"]["counts"].setdefault(k, 0)
        weights[name] = real - 1
    return _lin_combine(base, deltas, weights)


def dry_run_step(cfg, mesh, shape: InputShape, mesh_name: str, *, serve_mode: str = "serve",
                 extrapolate: bool = True, tag: str = "") -> dict:
    """The record of ``cfg``'s step for ``shape`` on ``mesh``: the full-depth
    step run once under the counters (its memory stats, and its counts
    unless ``extrapolate``), the counts from the 1- and 2-unit variants
    with ``extrapolate``.  ``cfg`` as given (the caller pads it)."""
    kw = _step_kwargs(shape, serve_mode)
    cost, mem, t_trace = count_step(cfg, mesh, shape, **kw)
    t_extra = 0.0
    if extrapolate:
        t0 = time.perf_counter()
        cost = _extrapolated_cost(shape, mesh, cfg, serve_mode=serve_mode)
        t_extra = time.perf_counter() - t0
    rec = analyze(cfg, shape, mesh_name, mesh.size, cost, memory_stats=mem,
                  note=f"mode={serve_mode}{(' ' + tag) if tag else ''}")
    result = json.loads(rec.to_json())
    result.update({"status": "ok", "t_trace_s": t_trace, "t_extrapolate_s": t_extra})
    return result


def _save(rec: dict, arch: str, shape_name: str, mesh_kind: str, tag: str = "") -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    safe = arch.replace(".", "_").replace("/", "_")
    suffix = f"_{tag}" if tag else ""
    with open(os.path.join(OUT_DIR, f"{safe}__{shape_name}__{mesh_kind}{suffix}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)


def run_one(arch: str, shape_name: str, mesh_kind: str, *, serve_mode: str = "serve",
            save: bool = True, tag: str = "", extrapolate: bool = True,
            cfg_overrides: dict | None = None):
    """One record: ``mesh_kind`` ``single`` (16x16), ``multi`` (2x16x16) or
    ``<d>x<m>`` (another factorization of 256)."""
    shape = INPUT_SHAPES[shape_name]
    if mesh_kind == "multi":
        mesh_ctx = production_mesh(multi_pod=True)
    elif "x" in mesh_kind:
        mesh_ctx = production_mesh(layout=mesh_kind)
    else:
        mesh_ctx = production_mesh()
    with mesh_ctx as mesh:
        cfg = get_config(arch).with_padding(mesh.shape["model"])
        if cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
        serve_mode = resolve_serve_mode(cfg, mesh, serve_mode)
        ok, why = supports_shape(cfg, shape)
        if not ok:
            print(f"SKIP  {arch} x {shape_name} x {mesh_kind}: {why}")
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "status": "skip", "reason": why}
            if save:
                _save(rec, arch, shape_name, mesh_kind)
            return rec
        rec = dry_run_step(cfg, mesh, shape, mesh_kind, serve_mode=serve_mode,
                           extrapolate=extrapolate, tag=tag)
    print(f"OK    {arch} x {shape_name} x {mesh_kind}: "
          f"trace {rec['t_trace_s']:.1f}s extrapolate {rec['t_extrapolate_s']:.1f}s | "
          f"Tc={rec['t_compute']*1e3:.2f}ms Tm={rec['t_memory']*1e3:.2f}ms "
          f"Tcoll={rec['t_collective']*1e3:.2f}ms -> {rec['bottleneck']} "
          f"useful={rec['useful_ratio']:.2f}")
    if save:
        _save(rec, arch, shape_name, mesh_kind, tag)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="CLI id, e.g. granite-3-2b")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    help="single (16x16), multi (2x16x16), both or <d>x<m>")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--serve-mode", default="serve",
                    choices=["serve", "serve_tp", "serve_auto", "serve_ws", "train"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-extrapolate", action="store_true")
    args = ap.parse_args(argv)
    # DTensor logs a performance note for every multi-axis redistribution
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]  # or "32x8" etc.
    archs = list(CLI_ALIASES) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]

    t0 = time.perf_counter()
    failures = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    run_one(arch, shape, mesh_kind, serve_mode=args.serve_mode, tag=args.tag,
                            extrapolate=not args.no_extrapolate)
                except Exception as e:
                    failures.append((arch, shape, mesh_kind, repr(e)))
                    print(f"FAIL  {arch} x {shape} x {mesh_kind}: {e}")
                    traceback.print_exc()
    print(f"\n{len(meshes) * len(archs) * len(shapes)} records in "
          f"{time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()

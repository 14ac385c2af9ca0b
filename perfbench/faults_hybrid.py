"""Faults planted in the program of a granite_hybrid cell, read as
``control.py`` reads a seed: the check's numbers of a program that is
wrong in one known way, so that each limit can be set below them.

    python3 perfbench/faults_hybrid.py --workload <cell> --fault <name> --seeds 1-2 \
        [--seconds 4] [--out build/control]

Faults:

* ``rope``: RoPE applied in the attention layers, which have none;
* ``no_shared``: the shared expert left out of every layer;
* ``capacity``: the MoE through the capacity path (``models.moe.moe_apply``
  at the configuration's capacity factor), which drops what an expert is
  routed beyond its slots;
* ``zero_ssm``: the last Mamba2 layer's SSM state left at zero in the
  cache;
* ``zero_k``: the last attention layer's keys left at zero in the cache.

The benchmark's own runs never run it."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FAULTS = ("rope", "no_shared", "capacity", "zero_ssm", "zero_k")


def _zeroed(fn, mixer: str, leaf: str):
    def broken(*args, **kwargs):
        logits, cache = fn(*args, **kwargs)
        cache["granite_hybrid"][mixer][leaf][-1].zero_()
        return logits, cache
    return broken


def planted(fault: str, cfg):
    """Patch ``fault`` into the program; returns (the configuration the
    program runs, the undo)."""
    import repro_torch.models as models
    from repro_torch.models import transformer
    from repro_torch.models.moe import moe_apply, moe_apply_dropless

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    saved = []

    def patch(mod, name, value):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    if fault == "rope":
        cfg = dataclasses.replace(cfg, position_embedding_type="rope")
    elif fault == "no_shared":
        def moe_alone(p, c, x):
            b, s, d = x.shape
            y, aux = moe_apply_dropless(p["moe"], c, x.reshape(b * s, d))
            return y.reshape(b, s, d), aux
        patch(transformer, "_moe_shared", moe_alone)
    elif fault == "capacity":
        patch(transformer, "moe_apply_dropless", lambda p, c, x: moe_apply(p, c, x))
    else:
        mixer, leaf = ("mamba", "ssm") if fault == "zero_ssm" else ("attn", "k")
        patch(models, "prefill", _zeroed(models.prefill, mixer, leaf))

    def undo():
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)
    return cfg, undo


def readings(wl: dict, seed: int, seconds: float, fault: str, device, c=None, cfg=None):
    """The check's numbers of one seed with ``fault`` planted."""
    from perfbench import control, harness

    c = c if c is not None else harness.load_config(wl["config"])
    cfg = cfg if cfg is not None else harness.arch_config(c)
    cfg, undo = planted(fault, cfg)
    try:
        return control.readings(wl, seed, seconds, False, device, c=c, cfg=cfg)["program"]
    finally:
        undo()


def main(argv=None) -> int:
    from perfbench import control, harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "control"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("faults_hybrid.py needs a CUDA card", file=sys.stderr)
        return 2
    wl = harness.load_workload(args.workload)
    rows = []
    for seed in control.seed_list(args.seeds):
        t0 = time.perf_counter()
        got = readings(wl, seed, args.seconds, args.fault, "cuda")
        rows.append({"seed": seed, "fault": args.fault, "program": got,
                     "limits": wl["limits"], "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}.{args.fault}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

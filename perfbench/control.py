"""The readings that set each cell's limits: the program's numbers over
many seeds, and the control's over some of them.

    python3 perfbench/control.py --workload <cell> --seeds 1-12 --control-seeds 1-3 \
        [--seconds 4] [--out build/control]

For each seed it runs the cell as ``run.py`` does (set-up, a short window
at the cell's own load, the program's state freed) and reads the
comparison with the plain f32 reference; on the control seeds it also
reads the control: the same reference computed in float8 e4m3 wherever
the program holds bf16 (the nearest precision below the configuration's),
put in the program's place and judged the same way.  ``--fault`` plants
one of the faults a cell can have in the program instead.  The
benchmark's own runs never run it.  Writes one JSON file a cell and
prints each reading."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def seed_list(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def altered(fn):
    """``prefill`` with the token it produces for each sequence replaced by
    the one its logits put last."""
    def broken(*args, **kwargs):
        logits, cache = fn(*args, **kwargs)
        logits = logits.clone()
        rows = torch.arange(logits.shape[0], device=logits.device)
        logits[rows, logits.argmin(-1)] = logits.max(-1).values + 1.0
        return logits, cache
    return broken


def cache_altered(fn):
    """``prefill`` whose cache lacks the last layer's keys (left at zero)."""
    def broken(*args, **kwargs):
        logits, cache = fn(*args, **kwargs)
        cache["decoder"]["k"][-1].zero_()
        return logits, cache
    return broken


def train_fault(make, fault: str):
    """``make_train_step`` whose step returns its state unchanged
    (``unchanged``) or leaves out half of the batch, the mean taken over the
    rest (``half_batch``)."""
    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(params, state, batch):
            if fault == "unchanged":
                _, _, out = step(params, state, batch)
                return params, state, out
            half = batch["tokens"].shape[0] // 2
            return step(params, state, {k: v[:half] for k, v in batch.items()})
        return broken
    return make_broken


def planted(fault: str | None):
    """Patch ``fault`` into the program; returns the undo."""
    if fault is None:
        return lambda: None
    import repro_torch.launch.steps as steps
    import repro_torch.models as models

    if fault in ("altered", "cache_altered"):
        saved = [(models, "prefill", models.prefill)]
        models.prefill = (altered if fault == "altered" else cache_altered)(models.prefill)
    else:
        saved = [(steps, "make_train_step", steps.make_train_step)]
        steps.make_train_step = train_fault(steps.make_train_step, fault)

    def undo():
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    return undo


def readings(wl: dict, seed: int, seconds: float, control: bool, device, c=None, cfg=None,
             fault: str | None = None):
    """{"program": {...}, "control": {...} or None} of one seed, with
    ``fault`` planted in the program."""
    from perfbench import harness

    c = c if c is not None else harness.load_config(wl["config"])
    cfg = cfg if cfg is not None else harness.arch_config(c)
    run = harness.Run(wl, c, cfg, seed, seconds, False, torch.device(device),
                      time.perf_counter())
    driver = harness.load_module("drivers", wl["driver"]).Driver(run)
    undo = planted(fault)
    try:
        driver.setup()
        driver.window(seconds)
    finally:
        undo()
    driver.free()
    out = driver.check(control=control)
    if not control:
        out = {"program": out, "control": None}
    del driver, run
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "control"))
    ap.add_argument("--fault", default=None,
                    choices=("altered", "cache_altered", "unchanged", "half_batch"))
    args = ap.parse_args(argv)

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    wl = harness.load_workload(args.workload)
    controls = set(seed_list(args.control_seeds)) if args.control_seeds else set()
    rows = []
    for seed in seed_list(args.seeds):
        t0 = time.perf_counter()
        got = readings(wl, seed, args.seconds, seed in controls, "cuda", fault=args.fault)
        rows.append({"seed": seed, **got, "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = f".{args.fault}" if args.fault else ""
    (out / f"{args.workload}{tag}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

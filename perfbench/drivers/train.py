"""Training: ``launch.steps.make_train_step(cfg, use_remat=False)``, the
step ``launch/train.py`` runs (the loss by autograd through the
hand-written backward kernels, then AdamW), back to back on fresh batches
of random tokens, with no synchronize between steps; the loss is read on
the host every ``log_every`` steps, as a job logs it.

Set-up builds the one step, its parameters and AdamW's state, and drives
them through the first ``check.steps`` steps on the first batches of the
pool; the window goes on with the same objects on the next batches.  What
those first steps left is read at once: each step's loss, the first
gradient as the optimizer got it (its first moment after one step, over
1 - b1, the clipping undone by the step's own gradient norm), and the
parameters' change after the last of them, leaf by leaf.

The check runs the plain f32 reference (``reference/train.py``) through
the same steps from the same weights and batches, and compares: the
loss of each step, and the gradient and change norms of the worst leaf,
each gap measured against the reference's norm of that leaf or of the
median leaf, whichever is larger.  Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change."""
from __future__ import annotations

import time

import torch

from perfbench import modelflops, weights
from perfbench.drivers.prefill import traffic_seed
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def worst_gap(got: dict, want: dict, keys=None) -> float:
    """max over leaves of |got - want| / max(want, median of want)."""
    keys = list(want) if keys is None else keys
    med = _median([want[k] for k in want])
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys)


def readings(got: dict, want: dict) -> dict:
    """The gaps of a run ``got`` ({"losses", "grad_norms", "change_norms"})
    against the reference's ``want``."""
    loss_gap = max(abs(p - w) / abs(w) for p, w in zip(got["losses"], want["losses"]))
    g = want["grad_norms"]
    med = _median(list(g.values()))
    moved = [k for k in g if g[k] >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_norm_gap": worst_gap(got["grad_norms"], g),
            "change_norm_gap": worst_gap(got["change_norms"], want["change_norms"], moved)}


class Driver:
    phase = "train"

    def __init__(self, run):
        self.run = run
        self.wl = run.wl
        self.done = 0

    @property
    def attempted(self) -> int:
        return self.done

    def batch(self, i: int) -> dict:
        rows = self.pool[i % self.wl["pool"]]
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def setup(self):
        from repro_torch.launch.steps import make_train_step
        from repro_torch.train.optim import adamw

        r, wl = self.run, self.wl
        lr, b1, clip = wl["lr"], ref_train.ADAMW["b1"], ref_train.ADAMW["clip"]
        self.params = weights.make(r.cfg, r.seed, r.device)
        r.mark("weights")
        self.opt = adamw(lr)[0](self.params)
        self.step = make_train_step(r.cfg, use_remat=False, lr=lr)
        gen = torch.Generator(device=r.device).manual_seed(traffic_seed(r.seed))
        self.pool = torch.randint(0, r.cfg.vocab_size, (wl["pool"], wl["batch"], wl["seq"] + 1),
                                  generator=gen, device=r.device)
        r.shape = (wl["batch"], wl["seq"])
        losses = []
        for i in range(wl["check"]["steps"]):
            self.params, self.opt, out = self.step(self.params, self.opt, self.batch(i))
            losses.append(float(out["loss"]))
            if i == 0:
                scale = min(1.0, clip / (float(out["grad_norm"]) + 1e-12))
                self.grad_norms = {k: float(m.norm()) / (1.0 - b1) / scale
                                   for k, m in ref_train.leaves(self.opt.mu)}
        self.losses = losses
        start = dict(ref_train.leaves(weights.make(r.cfg, r.seed, r.device)))
        self.change_norms = {k: float((p.float() - start[k].float()).norm())
                             for k, p in ref_train.leaves(self.params)}
        del start
        self.next = wl["check"]["steps"]

    def _step(self):
        t0 = time.perf_counter()
        self.params, self.opt, out = self.step(self.params, self.opt, self.batch(self.next))
        t1 = time.perf_counter()
        self.next += 1
        if self.next % self.wl["log_every"] == 0:
            float(out["loss"])
        return t1 - t0

    def steps(self, n: int):
        for _ in range(n):
            self._step()

    def window(self, seconds: float, with_flops: bool = False):
        r, wl = self.run, self.wl
        t_begin = time.perf_counter()
        while time.perf_counter() - t_begin < seconds:
            r.dispatch_s.append(self._step())
            self.done += 1
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
        r.window_s = time.perf_counter() - t_begin
        r.units = self.done
        r.tokens = self.done * wl["batch"] * wl["seq"]
        if with_flops:
            r.flops = self.done * modelflops.train_flops(r.c, wl["batch"], wl["seq"])

    def free(self):
        del self.params, self.opt, self.step

    def reference(self, prec) -> dict:
        r, wl = self.run, self.wl
        p32 = weights.make(r.cfg, r.seed, r.device, dtype=torch.float32)
        dtypes = weights.dtypes(r.cfg)
        batches = [(b["tokens"], b["labels"]) for b in
                   (self.batch(i) for i in range(wl["check"]["steps"]))]
        with ref.no_tf32():
            return ref_train.run(p32, r.c, batches, wl["lr"], dtypes, prec)

    def check(self, control: bool = False) -> dict:
        want = self.reference(ref.Precision())
        got = {"losses": self.losses, "grad_norms": self.grad_norms,
               "change_norms": self.change_norms}
        out = readings(got, want)
        if control:
            # the fp8 control in the program's place, read as the program is
            out = {"program": out, "control": readings(self.reference(ref.Precision(fp8=True)),
                                                       want)}
        return out

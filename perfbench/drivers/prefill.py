"""Prefill: batches of prompts served back to back in a closed loop, as
``launch/serve.py::serve`` times them.

Each call is ``models.prefill`` of one batch into a cache of ``max_len``
slots, then the batch's first tokens (argmax of the last logits) copied
to the host; its time on the host clock from the call to the copy is the
request's time to its first token, and the host time to ``prefill``'s
return its dispatch.  The prompts are a pool of ``pool`` batches drawn on
the card from the seed; the window walks through it in order.

Of each call in the window one sequence, drawn from the seed before the
window, keeps what ``prefill`` wrote into its cache at ``check.positions``
positions (the last and others drawn from the seed): each layer's keys
and values, gathered once the batch's tokens are on the host, outside
the time to its first token.

The check: a sample of those sequences, drawn from the seed, is run
through the plain f32 reference (``reference/model.py``) in blocks, and
two numbers are compared: ``logit_gap_max``, the widest gap by which a
served token's reference logit lies below the reference's best (0 where
the two agree), and ``kv_gap_max``, the widest distance of a layer's
cached keys or values from the reference's, over the norm of the
reference's (at the kept positions)."""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import modelflops, weights
from perfbench.reference import model as ref


def traffic_seed(seed: int) -> int:
    return (int(seed) * 6_364_136_223_846_793_005 + 1) % (2**63 - 1)


class Driver:
    phase = "prefill"

    def __init__(self, run):
        self.run = run
        self.wl = run.wl
        self.served = []          # (pool index, host tokens [B])
        self.kept = {}            # pool index -> (k, v) [L, Hkv, P, Dh] of its kept row

    @property
    def attempted(self) -> int:
        return len(self.served) * self.wl["batch"]

    def setup(self):
        r, wl = self.run, self.wl
        self.params = weights.make(r.cfg, r.seed, r.device)
        r.mark("weights")
        gen = torch.Generator(device=r.device).manual_seed(traffic_seed(r.seed))
        self.pool = torch.randint(0, r.cfg.vocab_size, (wl["pool"], wl["batch"], wl["prompt_len"]),
                                  generator=gen, device=r.device)
        r.shape = (wl["batch"], wl["prompt_len"])
        rng = np.random.default_rng([int(r.seed), 2])
        self.rows = rng.integers(0, wl["batch"], size=wl["pool"])
        last = wl["prompt_len"] - 1
        pos = sorted(rng.choice(last, size=wl["check"]["positions"] - 1, replace=False)) + [last]
        self.positions = torch.tensor(pos, device=r.device)
        for i in range(wl["warmup"]):
            self._call(wl["pool"] - 1 - i, keep=True)
        self.kept.clear()
        self.next = 0

    def _call(self, i: int, keep: bool = False):
        from repro_torch.models import prefill

        i %= self.wl["pool"]
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, cache = prefill(self.params, self.run.cfg, self.pool[i], self.wl["max_len"])
            t1 = time.perf_counter()
            tok = logits.argmax(-1).cpu()
            t2 = time.perf_counter()
            if keep:
                row, kv = int(self.rows[i]), cache["decoder"]
                self.kept[i] = tuple(kv[n][:, row].index_select(-2, self.positions)
                                     for n in ("k", "v"))
        del logits, cache
        return t1 - t0, t2 - t0, tok

    def steps(self, n: int):
        for _ in range(n):
            self.served.append((self.next, self._call(self.next)[2]))
            self.next += 1

    def window(self, seconds: float, with_flops: bool = False):
        r, wl = self.run, self.wl
        t_begin = time.perf_counter()
        while True:
            dispatch, total, tok = self._call(self.next, keep=True)
            self.served.append((self.next, tok))
            self.next += 1
            r.dispatch_s.append(dispatch)
            r.call_s.append(total)
            if time.perf_counter() - t_begin >= seconds:
                break
        r.window_s = time.perf_counter() - t_begin
        r.units = len(r.call_s)
        r.tokens = r.units * wl["batch"] * wl["prompt_len"]
        if with_flops:
            r.flops = r.units * modelflops.prefill_flops(r.c, wl["batch"], wl["prompt_len"])

    def free(self):
        del self.params

    def sample(self) -> list:
        """(pool index, row, served token) of the sequences checked: drawn
        from the seed among the window's kept sequences."""
        seqs, seen = [], set()
        for i, tok in self.served:
            i %= self.wl["pool"]
            if i in self.kept and i not in seen:
                seen.add(i)
                seqs.append((i, int(self.rows[i]), int(tok[self.rows[i]])))
        rng = np.random.default_rng([int(self.run.seed), 1])
        pick = rng.choice(len(seqs), size=min(self.wl["check"]["sample"], len(seqs)),
                          replace=False)
        return [seqs[j] for j in sorted(pick)]

    def check(self, control: bool = False) -> dict:
        """{"logit_gap_max", "kv_gap_max"}; with ``control`` also the same of
        the fp8 control at the same sequences: the gap of the token it puts
        first, and its keys and values against the reference's."""
        r = self.run
        params = weights.make(r.cfg, r.seed, r.device, dtype=torch.float32)
        seqs = self.sample()
        gaps = {"logit_gap_max": [], "kv_gap_max": []}
        low_gaps = {"logit_gap_max": [], "kv_gap_max": []}
        blk = self.wl["check"]["block"]
        with torch.no_grad(), ref.no_tf32():
            for j in range(0, len(seqs), blk):
                part = seqs[j:j + blk]
                toks = torch.stack([self.pool[i, row] for i, row, _ in part])
                served = torch.tensor([t for _, _, t in part], device=r.device)
                kv = ref.KV(self.positions)
                want = ref.last_logits(params, r.c, toks, ref.Precision(), kv)
                gaps["logit_gap_max"].append(ref.served_gap(want, served))
                got = [torch.stack([self.kept[i][n] for i, _, _ in part]) for n in (0, 1)]
                gaps["kv_gap_max"].append(kv_gaps(got, kv))
                if control:
                    low_kv = ref.KV(self.positions)
                    low = ref.last_logits(params, r.c, toks, ref.Precision(fp8=True), low_kv)
                    low_gaps["logit_gap_max"].append(ref.served_gap(want, low.argmax(-1)))
                    low_gaps["kv_gap_max"].append(
                        kv_gaps([torch.stack(low_kv.k, 1), torch.stack(low_kv.v, 1)], kv))
        out = {k: float(torch.cat(v).max()) for k, v in gaps.items()}
        if control:
            out = {"program": out,
                   "control": {k: float(torch.cat(v).max()) for k, v in low_gaps.items()}}
        return out


def kv_gaps(got: list, kv) -> torch.Tensor:
    """Each (sequence, layer, keys or values)'s distance from the reference,
    over the reference's norm: ``got`` the keys and values [n, L, Hkv, P,
    Dh], ``kv`` the reference's ``KV`` of the same sequences."""
    out = []
    for have, want in zip(got, (torch.stack(kv.k, 1), torch.stack(kv.v, 1))):
        diff = (have.float() - want).flatten(2).norm(dim=-1)
        out.append(diff / want.flatten(2).norm(dim=-1).clamp_min(1e-30))
    return torch.cat(out).flatten()

"""Prefill of a granite_hybrid model (granite-4.0-h-small): batches of
prompts served back to back in a closed loop, timed exactly as
``drivers/prefill.py`` times them (a pool of batches drawn on the card from
the seed, the time to the first token to the token copy, dispatch to
``prefill``'s return).

Of each call in the window one sequence, drawn from the seed before the
window, keeps what ``prefill`` wrote into its cache: each attention
layer's keys and values at ``check.positions`` positions (the last and
others drawn from the seed), and each Mamba2 layer's final SSM state over
``check.ssm_heads`` heads drawn from the seed, so that a window's keeps
stay near 1 GB; gathered once the batch's tokens are on the host,
outside the time to its first token.

The check: a sample of those sequences, drawn from the seed, is run
through the plain f32 reference (``reference/granite_hybrid.py``) in
blocks, on the program's own bf16 weights made again from the seed, and
three numbers are compared: ``logit_gap_max`` (as ``drivers/prefill.py``:
how far a served token's reference logit lies below the reference's
best), ``kv_gap_max`` (the widest distance of an attention layer's cached
keys or values from the reference's, over the norm of the reference's)
and ``ssm_gap_max`` (the same of a Mamba2 layer's kept final state)."""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import modelflops_hybrid, weights_hybrid
from perfbench.drivers import prefill
from perfbench.reference import granite_hybrid as ref
from perfbench.reference.model import served_gap

GROUP = "granite_hybrid"


class Driver(prefill.Driver):
    def setup(self):
        r, wl = self.run, self.wl
        self.params = weights_hybrid.make(r.cfg, r.seed, r.device)
        r.mark("weights")
        gen = torch.Generator(device=r.device).manual_seed(prefill.traffic_seed(r.seed))
        self.pool = torch.randint(0, r.cfg.vocab_size, (wl["pool"], wl["batch"], wl["prompt_len"]),
                                  generator=gen, device=r.device)
        r.shape = (wl["batch"], wl["prompt_len"])
        rng = np.random.default_rng([int(r.seed), 2])
        self.rows = rng.integers(0, wl["batch"], size=wl["pool"])
        last = wl["prompt_len"] - 1
        pos = sorted(rng.choice(last, size=wl["check"]["positions"] - 1, replace=False)) + [last]
        self.positions = torch.tensor(pos, device=r.device)
        heads = rng.choice(r.cfg.ssm_heads, size=wl["check"]["ssm_heads"], replace=False)
        self.heads = torch.tensor(sorted(heads), device=r.device)
        for i in range(wl["warmup"]):
            self._call(wl["pool"] - 1 - i, keep=True)
        self.kept.clear()
        self.next = 0

    def _call(self, i: int, keep: bool = False):
        from repro_torch.models import prefill as program_prefill

        i %= self.wl["pool"]
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, cache = program_prefill(self.params, self.run.cfg, self.pool[i],
                                            self.wl["max_len"])
            t1 = time.perf_counter()
            tok = logits.argmax(-1).cpu()
            t2 = time.perf_counter()
            if keep:
                row, g = int(self.rows[i]), cache[GROUP]
                kv = tuple(g["attn"][n][:, row].index_select(-2, self.positions)
                           for n in ("k", "v"))
                self.kept[i] = kv + (g["mamba"]["ssm"][:, row].index_select(1, self.heads),)
        del logits, cache
        return t1 - t0, t2 - t0, tok

    def window(self, seconds: float, with_flops: bool = False):
        super().window(seconds)
        r, wl = self.run, self.wl
        if with_flops:
            r.flops = r.units * modelflops_hybrid.prefill_flops(r.c, wl["batch"],
                                                                wl["prompt_len"])

    def check(self, control: bool = False) -> dict:
        """{"logit_gap_max", "kv_gap_max", "ssm_gap_max"}; with ``control``
        also the same of the fp8 control at the same sequences."""
        r = self.run
        params = weights_hybrid.make(r.cfg, r.seed, r.device)
        seqs = self.sample()
        names = ("logit_gap_max", "kv_gap_max", "ssm_gap_max")
        gaps = {k: [] for k in names}
        low_gaps = {k: [] for k in names}
        blk = self.wl["check"]["block"]
        with torch.no_grad(), ref.no_tf32():
            for j in range(0, len(seqs), blk):
                part = seqs[j:j + blk]
                toks = torch.stack([self.pool[i, row] for i, row, _ in part])
                served = torch.tensor([t for _, _, t in part], device=r.device)
                keep = ref.Keep(self.positions, self.heads)
                want = ref.last_logits(params, r.c, toks, ref.Precision(), keep)
                gaps["logit_gap_max"].append(served_gap(want, served))
                got = [torch.stack([self.kept[i][n] for i, _, _ in part]) for n in range(3)]
                gaps["kv_gap_max"].append(state_gaps(got[:2], [keep.k, keep.v]))
                gaps["ssm_gap_max"].append(state_gaps(got[2:], [keep.ssm]))
                if control:
                    low = ref.Keep(self.positions, self.heads)
                    low_logits = ref.last_logits(params, r.c, toks, ref.Precision(fp8=True), low)
                    low_gaps["logit_gap_max"].append(served_gap(want, low_logits.argmax(-1)))
                    low_got = [torch.stack(t, 1) for t in (low.k, low.v, low.ssm)]
                    low_gaps["kv_gap_max"].append(state_gaps(low_got[:2], [keep.k, keep.v]))
                    low_gaps["ssm_gap_max"].append(state_gaps(low_got[2:], [keep.ssm]))
        out = {k: float(torch.cat(v).max()) for k, v in gaps.items()}
        if control:
            out = {"program": out,
                   "control": {k: float(torch.cat(v).max()) for k, v in low_gaps.items()}}
        return out


def state_gaps(got: list, want: list) -> torch.Tensor:
    """Each (sequence, layer, tensor)'s distance from the reference, over the
    reference's norm: ``got`` tensors [n, L, ...] (the program's, kept per
    sequence), ``want`` the reference's per layer, [n, ...] each."""
    out = []
    for have, ref_layers in zip(got, want):
        w = torch.stack(ref_layers, 1)
        diff = (have.float() - w).flatten(2).norm(dim=-1)
        out.append(diff / w.flatten(2).norm(dim=-1).clamp_min(1e-30))
    return torch.cat(out).flatten()

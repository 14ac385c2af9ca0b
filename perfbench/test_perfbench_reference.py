"""The benchmark's plain references against the port's CPU path, at the
configuration's reduced sizes in f32: the forward, the keys and values a
prefill caches, and the training step's loss, gradients and AdamW update
with the program's AdamW settings."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import weights
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train
from perfbench.drivers.train import readings


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def reduced(name: str):
    from repro_torch.configs import get_config

    cfg = get_config(name).reduced()
    return cfg, dataclasses.asdict(cfg)


def scale_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_forward_matches_port():
    from repro_torch.models import forward

    cfg, c = reduced("granite-3-2b")
    params = weights.make(cfg, 11, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port, _, _ = forward(params, cfg, tokens)
        want = ref.all_logits(params, c, tokens, ref.Precision())
    assert scale_err(port, want) < 1e-4


def test_cached_keys_and_values_match_port():
    """The reference's keys and values at chosen positions are what the
    port's prefill writes into its cache there."""
    from repro_torch.models import prefill

    from perfbench.drivers.prefill import kv_gaps

    cfg, c = reduced("granite-3-2b")
    params = weights.make(cfg, 12, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(4))
    pos = torch.tensor([0, 17, 30, 47])
    with torch.no_grad():
        _, cache = prefill(params, cfg, tokens, 64)
        kv = ref.KV(pos)
        ref.last_logits(params, c, tokens, ref.Precision(), kv)
    got = [cache["decoder"][n].index_select(-2, pos).transpose(0, 1) for n in ("k", "v")]
    assert len(kv.k) == cfg.num_layers
    assert float(kv_gaps(got, kv).max()) < 1e-5


def test_adamw_settings_are_the_programs(monkeypatch):
    """``reference/train.py``'s AdamW settings are those ``make_train_step``
    gives the program's AdamW: the schedule's length and warm-up, the
    moments' decays, epsilon, the weight decay and the clipping norm."""
    import inspect

    import repro_torch.launch.steps as steps

    seen = {name: p.default for name, p in inspect.signature(steps.adamw).parameters.items()}

    def schedule(lr, total_steps, warmup_steps=0):
        seen.update(lr=lr, total_steps=total_steps, warmup=warmup_steps)
        return lambda step: lr

    def adamw(learning_rate, **kw):
        seen.update(kw)
        return None, None

    monkeypatch.setattr(steps, "cosine_schedule", schedule)
    monkeypatch.setattr(steps, "adamw", adamw)
    steps.make_train_step(reduced("granite-3-2b")[0], use_remat=False, lr=0.05)
    assert seen["lr"] == 0.05
    got = {k: seen[k] for k in ("total_steps", "warmup", "b1", "b2", "eps", "weight_decay")}
    assert {**got, "clip": seen["clip_norm"]} == ref_train.ADAMW


def test_train_step_matches_port():
    """Three steps of the reference (loss, first gradient, change) against
    the port's ``make_train_step`` on the CPU, both in f32."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optim import adamw

    cfg, c = reduced("granite-3-2b")
    lr = 0.05
    g = torch.Generator().manual_seed(7)
    rows = [torch.randint(0, cfg.vocab_size, (2, 33), generator=g) for _ in range(3)]
    params = weights.make(cfg, 5, "cpu")
    state = adamw(lr)[0](params)
    step = make_train_step(cfg, use_remat=False, lr=lr)
    p, losses = params, []
    for i, r in enumerate(rows):
        p, state, out = step(p, state, {"tokens": r[:, :-1], "labels": r[:, 1:]})
        losses.append(float(out["loss"]))
        if i == 0:
            clip = min(1.0, 1.0 / (float(out["grad_norm"]) + 1e-12))
            grad_norms = {k: float(m.norm()) / 0.1 / clip for k, m in ref_train.leaves(state.mu)}
    start = dict(ref_train.leaves(params))
    got = {"losses": losses, "grad_norms": grad_norms,
           "change_norms": {k: float((v - start[k]).norm()) for k, v in ref_train.leaves(p)}}
    want = ref_train.run(params, c, [(r[:, :-1], r[:, 1:]) for r in rows], lr,
                         weights.dtypes(cfg), ref.Precision())
    gaps = readings(got, want)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_norm_gap"] < 1e-4
    assert gaps["change_norm_gap"] < 1e-3

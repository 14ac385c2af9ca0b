"""``repro_torch.learn`` — the continuous-learning plane (the reference's
``repro.learn`` on the port: the fine-tune runs on the port's training path,
on the card by default, and the rest is the reference's host code, copied).

Everything before this package *serves* models; nothing produced them.
``repro_torch.learn`` closes the loop on the recovery substrate:

* :class:`WalTrainingTap` / :class:`LabelLog` — committed WAL suffixes
  become labeled training examples (receptive cones reconstructed with
  the incremental DDS builder, delayed-label join, compaction pin);
* :class:`RollingWindowTrainer` / :class:`WindowPolicy` — Morpheus-DFP-
  style rolling windows fine-tune the LNN (local SGD/Adam, no optax) and
  optionally refit the hybrid GBDT head on the tuned embedding;
* :class:`PromotionController` — candidates shadow-score on live traffic
  and promote only on a recall@budget win, with automatic rollback to
  last-good on post-promotion regressions;
* :class:`ContinuousLearner` — the one orchestrator the gateway drives;
* :func:`drifting_attack_stream` — the mid-stream attack-shift workload
  the learning bench proves recall recovery on.

See ``docs/learning.md`` for the tap format, label-join semantics, the
window policy, and the promotion/rollback state diagram.

Exports resolve lazily (PEP 562), same as ``repro_torch.service``.
"""
from __future__ import annotations

__all__ = [
    "ContinuousLearner",
    "FineTuneResult",
    "LabelLog",
    "PromotionController",
    "RollingWindowTrainer",
    "TrainingExample",
    "WalTrainingTap",
    "WindowPolicy",
    "adam",
    "drifting_attack_stream",
    "recall_at_budget",
    "sgd",
]

_HOMES = {
    "ContinuousLearner": "repro_torch.learn.learner",
    "FineTuneResult": "repro_torch.learn.trainer",
    "LabelLog": "repro_torch.learn.tap",
    "PromotionController": "repro_torch.learn.promote",
    "RollingWindowTrainer": "repro_torch.learn.trainer",
    "TrainingExample": "repro_torch.learn.tap",
    "WalTrainingTap": "repro_torch.learn.tap",
    "WindowPolicy": "repro_torch.learn.trainer",
    "adam": "repro_torch.learn.trainer",
    "drifting_attack_stream": "repro_torch.learn.drift",
    "recall_at_budget": "repro_torch.learn.promote",
    "sgd": "repro_torch.learn.trainer",
}


def __getattr__(name: str):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module 'repro_torch.learn' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(home), name)
    globals()[name] = value    # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

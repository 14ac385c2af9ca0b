"""Shadow-gated promotion with automatic rollback — the reference's
``repro.learn.promote``, copied: host logic over the port's
:class:`~repro_torch.service.FraudService`.

The controller closes the deployment half of the loop: every fine-tune
candidate is registered and shadow-scored on **live traffic** (the
canary machinery, now collecting ``[label, primary, shadow]`` eval
triples), and only promoted when its recall@budget beats the incumbent's
by a configured margin on the same sampled responses — a paired
comparison, so traffic mix cancels out.

State machine (see ``docs/learning.md`` for the diagram)::

    idle --submit_candidate--> shadowing --beats incumbent--> watching
      ^                            |  (margin not met /            |
      |                            |   eval budget exhausted)      |
      +------- reject -------------+                               |
      ^                                                            |
      +-- rollback (divergence alert | recall regression) ---------+
      +-- cleared (watch window healthy) --------------------------+

After a promotion the controller keeps shadow-scoring the *displaced
incumbent* (``role='last_good'``): a sticky divergence alert or a recall
regression beyond ``rollback_margin`` triggers
:meth:`FraudService.rollback_model` — the same shared rollback path the
gateway's auto-rollback uses.  All eval state lives in the service's
shadow dict, which rides checkpoints: a crash mid-eval resumes the
window on restore (:meth:`PromotionController.attach`) instead of
double-counting.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["PromotionController", "recall_at_budget"]


def recall_at_budget(labels, scores, budget: float) -> float:
    """Recall among the top-``budget`` fraction by score (the paper's
    review-budget metric).  NaN labels are skipped; returns NaN when no
    labeled positives remain."""
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    keep = ~np.isnan(labels)
    labels, scores = labels[keep], scores[keep]
    pos = float((labels > 0.5).sum())
    if labels.size == 0 or pos == 0:
        return float("nan")
    k = max(1, int(round(budget * labels.size)))
    top = np.argsort(-scores, kind="stable")[:k]
    return float((labels[top] > 0.5).sum() / pos)


class PromotionController:
    """Drives candidate versions through shadow eval → promote → watch.

    All thresholds mirror :class:`~repro_torch.service.config.LearnSection`;
    the controller itself is stateless beyond its phase tag — the eval
    evidence lives in the service's checkpointed shadow dict, so
    :meth:`attach` can rebuild a controller mid-flight after a restore.
    """

    def __init__(self, service, *, promote_margin: float = 0.02,
                 min_eval: int = 32, min_eval_pos: int = 3,
                 eval_budget: float = 0.15, eval_max: int = 4096,
                 shadow_fraction: float = 1.0,
                 rollback_margin: float = 0.05, watch_min_eval: int = 32,
                 watch_divergence_threshold: float = 5.0):
        self.service = service
        self.promote_margin = float(promote_margin)
        self.min_eval, self.min_eval_pos = int(min_eval), int(min_eval_pos)
        self.eval_budget, self.eval_max = float(eval_budget), int(eval_max)
        self.shadow_fraction = float(shadow_fraction)
        self.rollback_margin = float(rollback_margin)
        self.watch_min_eval = int(watch_min_eval)
        self.watch_divergence_threshold = float(watch_divergence_threshold)
        self.state = "idle"          # 'idle' | 'shadowing' | 'watching'
        self.candidate_version: int | None = None
        self.stats = {"submitted": 0, "promoted": 0, "rejected": 0,
                      "rollbacks": 0, "cleared": 0}
        self.last_decision: dict | None = None

    # ---------------------------------------------------------------- attach
    @classmethod
    def attach(cls, service, **kwargs) -> "PromotionController":
        """Rebuild a controller from a (possibly restored) service: the
        shadow dict's ``role`` tag says which phase was in flight, and its
        checkpointed eval buffer resumes the window without double-counting
        (``tests/test_torch_learn_promotion.py``)."""
        ctl = cls(service, **kwargs)
        sh = service.shadow_stats()
        role = sh.get("role")
        if role == "candidate":
            ctl.state = "shadowing"
            ctl.candidate_version = int(sh["version"])
        elif role == "last_good":
            ctl.state = "watching"
            ctl.candidate_version = int(service.model_version)
        return ctl

    # ---------------------------------------------------------------- submit
    def submit_candidate(self, model, version: int | None = None) -> int:
        """Register ``model`` (an LNN pytree or a HybridModel) and start
        shadow-scoring it on live traffic.  One candidate at a time — a
        submission while not idle raises."""
        if self.state != "idle":
            raise RuntimeError(
                f"submit_candidate() while {self.state!r} — one candidate "
                "at a time; wait for promote/reject/rollback")
        v = self.service.register_model(model, version)
        self.service.enable_shadow(
            v, fraction=self.shadow_fraction, collect_eval=self.eval_max,
            role="candidate")
        self.candidate_version = v
        self.state = "shadowing"
        self.stats["submitted"] += 1
        return v

    # ------------------------------------------------------------------ step
    def _recalls(self, sh: dict) -> tuple[float, float, int, int]:
        """(primary_recall, shadow_recall, n_labeled, n_pos) from the
        eval triples."""
        ev = np.asarray(sh.get("eval", ()), np.float64).reshape(-1, 3)
        labels = ev[:, 0]
        keep = ~np.isnan(labels)
        n = int(keep.sum())
        pos = int((labels[keep] > 0.5).sum())
        return (recall_at_budget(labels, ev[:, 1], self.eval_budget),
                recall_at_budget(labels, ev[:, 2], self.eval_budget),
                n, pos)

    def step(self) -> dict | None:
        """Advance the state machine one tick; returns the decision made
        this tick (promote/reject/rollback/cleared) or None."""
        if self.state == "shadowing":
            return self._step_shadowing()
        if self.state == "watching":
            return self._step_watching()
        return None

    def _step_shadowing(self) -> dict | None:
        svc = self.service
        sh = svc.shadow_stats()
        if sh.get("role") != "candidate":   # shadow stolen out from under us
            self.state, self.candidate_version = "idle", None
            return None
        inc_recall, cand_recall, n, pos = self._recalls(sh)
        exhausted = len(sh.get("eval", ())) >= sh.get("eval_max", self.eval_max)
        if n < self.min_eval or pos < self.min_eval_pos:
            if not exhausted:
                return None            # keep collecting evidence
        beats = (not math.isnan(cand_recall) and not math.isnan(inc_recall)
                 and cand_recall >= inc_recall + self.promote_margin)
        decision = {
            "phase": "shadowing", "candidate": self.candidate_version,
            "incumbent": svc.model_version, "n_eval": n, "n_pos": pos,
            "incumbent_recall": inc_recall, "candidate_recall": cand_recall,
            "margin": self.promote_margin,
        }
        if beats:
            svc.activate_model(self.candidate_version)
            # keep watching: the displaced incumbent shadows the promotee
            last_good = svc.last_good_version
            if last_good is not None:
                svc.enable_shadow(
                    last_good, fraction=self.shadow_fraction,
                    threshold=self.watch_divergence_threshold,
                    collect_eval=self.eval_max, role="last_good")
                self.state = "watching"
            else:
                svc.disable_shadow()
                self.state, self.candidate_version = "idle", None
            self.stats["promoted"] += 1
            decision["action"] = "promote"
        elif exhausted or (n >= self.min_eval and pos >= self.min_eval_pos):
            svc.disable_shadow()
            self.state, self.candidate_version = "idle", None
            self.stats["rejected"] += 1
            decision["action"] = "reject"
        else:
            return None
        self.last_decision = decision
        return decision

    def _step_watching(self) -> dict | None:
        svc = self.service
        sh = svc.shadow_stats()
        if sh.get("role") != "last_good":
            self.state, self.candidate_version = "idle", None
            return None
        decision = {"phase": "watching", "promoted": svc.model_version}
        if sh.get("alert_active"):
            decision.update(action="rollback", reason="shadow divergence "
                            f"alert (max={sh['divergence_max']:.4g})")
            decision["restored"] = svc.rollback_model(decision["reason"])
        else:
            cand_recall, good_recall, n, pos = self._recalls(sh)
            decision.update(n_eval=n, n_pos=pos,
                            promoted_recall=cand_recall,
                            last_good_recall=good_recall)
            if (n >= self.watch_min_eval and pos >= self.min_eval_pos
                    and not math.isnan(cand_recall)
                    and not math.isnan(good_recall)
                    and cand_recall < good_recall - self.rollback_margin):
                decision.update(action="rollback", reason="recall regression "
                                f"({cand_recall:.3f} < {good_recall:.3f} - "
                                f"{self.rollback_margin})")
                decision["restored"] = svc.rollback_model(decision["reason"])
            elif len(sh.get("eval", ())) >= sh.get("eval_max", self.eval_max):
                svc.disable_shadow()   # watch window closed, promotee healthy
                decision["action"] = "cleared"
            else:
                return None
        if decision["action"] == "rollback":
            self.stats["rollbacks"] += 1
        else:
            self.stats["cleared"] += 1
        self.state, self.candidate_version = "idle", None
        self.last_decision = decision
        return decision

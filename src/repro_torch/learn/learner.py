"""The continuous-learning loop: tap → rolling trainer → promotion (the
reference's ``repro.learn.learner`` on the port).

:class:`ContinuousLearner` wires the three learn-plane pieces onto one
:class:`~repro_torch.service.FraudService` according to its
``config.learn`` section, and exposes the single :meth:`step` the
gateway's ``POST /admin/train`` (and the smoke example's driving loop)
calls: poll the WAL tap, feed the rolling-window trainer, fine-tune when
the window advances and the controller is idle, submit the candidate,
and tick the promotion state machine.

The learner holds **no** training state the service doesn't: the tap's
cursor is recoverable from the WAL, and the promotion evidence lives in
the checkpointed shadow dict — after a crash/restore,
``ContinuousLearner(service)`` re-attaches mid-eval
(:meth:`PromotionController.attach`).
"""
from __future__ import annotations

from repro_torch.learn.promote import PromotionController
from repro_torch.learn.tap import LabelLog, WalTrainingTap
from repro_torch.learn.trainer import RollingWindowTrainer, WindowPolicy

__all__ = ["ContinuousLearner"]


class ContinuousLearner:
    """Orchestrates WAL-tap → fine-tune → shadow-gated promotion.

    Requires a streaming service with an enabled WAL (the tap's source).
    ``section`` defaults to ``service.config.learn``; ``label_log`` is
    shared with whoever records delayed outcomes (the gateway, a test).
    The fine-tunes run on the service's device (``FraudService(...,
    device=)``: CUDA by default).
    """

    def __init__(self, service, section=None, *,
                 label_log: LabelLog | None = None):
        section = service.config.learn if section is None else section
        if service.wal is None:
            raise RuntimeError(
                "ContinuousLearner needs an enabled WAL — call "
                "service.enable_wal(root) before attaching the learn plane")
        self.service = service
        self.section = section
        cfg = service.config.to_lnn_config()
        eng = service.config.engine
        self.label_log = label_log if label_log is not None else LabelLog()
        self.tap = WalTrainingTap(
            service.wal, cfg.feat_dim, label_log=self.label_log,
            label_latency_s=section.label_latency_s,
            include_ingest=section.include_ingest,
            entity_history=eng.entity_history, max_history=eng.max_history)
        self.trainer = RollingWindowTrainer(
            cfg,
            WindowPolicy(min_window=section.min_window,
                         max_window=section.max_window,
                         stride=section.stride, dedup=section.dedup),
            optimizer=section.optimizer, lr=section.lr, steps=section.steps,
            head=section.head, gbdt_trees=section.gbdt_trees,
            k_max=eng.k_max, max_deg=eng.max_deg,
            entity_history=eng.entity_history, max_history=eng.max_history,
            in_process=section.train_in_process, device=service.device)
        self.controller = PromotionController.attach(
            service,
            promote_margin=section.promote_margin,
            min_eval=section.min_eval, min_eval_pos=section.min_eval_pos,
            eval_budget=section.eval_budget, eval_max=section.eval_max,
            shadow_fraction=section.shadow_fraction,
            rollback_margin=section.rollback_margin,
            watch_min_eval=section.watch_min_eval,
            watch_divergence_threshold=section.watch_divergence_threshold)
        self.fires = 0
        self.last_result = None      # last FineTuneResult summary

    # ------------------------------------------------------------------ step
    def step(self, now: float | None = None, force: bool = False) -> dict:
        """One learn tick: poll the tap, maybe fine-tune + submit, tick the
        promotion controller.  ``force=True`` fires a fine-tune regardless
        of the window policy (the ``POST /admin/train`` escape hatch) as
        long as any examples are buffered.  Returns a summary dict."""
        examples = self.tap.poll(now)
        self.trainer.extend(examples)
        trained = None
        can_fire = self.controller.state == "idle" \
            and (self.trainer.ready()
                 or (force and self.trainer.stats["examples"] > 0))
        if can_fire:
            warm = self.service.model_params()
            from repro_torch.models.hybrid import HybridModel

            if isinstance(warm, HybridModel):
                warm = warm.lnn_params     # fine-tune from the embedded LNN
            result = self.trainer.train(warm)
            self.fires += 1
            trained = {"window": result.window, "steps": result.steps,
                       "head": result.head, "loss": result.losses[-1]}
            self.last_result = trained
            trained["candidate"] = self.controller.submit_candidate(
                result.model)
        decision = self.controller.step()
        return {"examples": len(examples), "trained": trained,
                "decision": decision, "state": self.controller.state}

    def stats(self) -> dict:
        """One JSON-able snapshot for ``GET /v1/learn/stats``."""
        return {
            "state": self.controller.state,
            "candidate_version": self.controller.candidate_version,
            "fires": self.fires,
            "tap": {**self.tap.stats, "cursor": self.tap.cursor,
                    "pending": self.tap.pending,
                    "labels_recorded": self.label_log.recorded},
            "trainer": dict(self.trainer.stats),
            "promotion": dict(self.controller.stats),
            "last_result": self.last_result,
            "last_decision": self.controller.last_decision,
            "last_rollback": self.service.last_rollback,
        }

    def close(self) -> None:
        """Release the tap's WAL pin."""
        self.tap.close()

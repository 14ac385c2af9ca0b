"""The port's promotion state machine and continuous-learning loop
(``repro_torch.learn.promote``, ``repro_torch.learn.learner``) on the CPU,
held against the reference's on the same inputs.

Every transition of the reference's ``tests/test_learn_promotion.py`` runs
on a port service and on a reference service built from the same weights,
with the same eval triples injected into each one's shadow dict: the port's
controller must make the reference controller's decisions, dict for dict,
and the services must end in the same state.  A crash mid-eval and mid-watch
restores on the port.  The closed loop (drifting traffic → WAL tap →
rolling fine-tune → shadow-gated promotion → an injected regression rolled
back) runs at the reference test's size through both packages: the first
fine-tune's losses agree within 1e-5 relative, and the sequence of actions
is the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
import repro.learn as RL
import repro.learn.promote as RP
import repro.service as RSV
from repro.data.attacks import AttackConfig as RefAttackConfig
from repro_torch.core import LNNConfig
from repro_torch.core.hetero import ENTITY_TYPE_NAMES
from repro_torch.data.attacks import AttackConfig
from repro_torch.learn import ContinuousLearner, drifting_attack_stream
from repro_torch.learn.promote import PromotionController
from repro_torch.params import from_numpy
from repro_torch.service import FraudService, ModelSection, ServiceConfig

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small products, and under several test
    workers torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(params):
    return from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def world():
    """The reference's stream and weights; the port's copies of both."""
    events, g, _ = RD.generate_event_stream(
        RD.SynthConfig(num_users=30, num_rings=2, feature_noise=0.8, seed=5), rate_per_s=500.0)
    ref_cfg = R.LNNConfig(num_gnn_layers=2, hidden_dim=8, feat_dim=g.order_features.shape[1],
                          mlp_dims=(8,))
    params = R.lnn_init(jax.random.PRNGKey(0), ref_cfg)
    cfg = LNNConfig(**{f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(LNNConfig)})
    return events, ref_cfg, params, cfg, _to_port(params)


#: per package: its service, config, controller, and how to build one
PKGS = {
    "port": dict(FraudService=FraudService, ServiceConfig=ServiceConfig,
                 ModelSection=ModelSection, Controller=PromotionController,
                 device=dict(device="cpu")),
    "ref": dict(FraudService=RSV.FraudService, ServiceConfig=RSV.ServiceConfig,
                ModelSection=RSV.ModelSection, Controller=RP.PromotionController, device={}),
}


def _build(world, pkg):
    _events, ref_cfg, ref_params, cfg, params = world
    ns = PKGS[pkg]
    c, p = (cfg, params) if pkg == "port" else (ref_cfg, ref_params)
    sc = ns["ServiceConfig"](mode="streaming", model=ns["ModelSection"].from_lnn_config(c)
                             ).replace(engine={"num_workers": 1, "max_batch": 4})
    return ns["FraudService"](sc, params=p, **ns["device"]).build()


_CTL = dict(promote_margin=0.1, min_eval=16, min_eval_pos=2, eval_budget=0.25, eval_max=64,
            watch_min_eval=16, rollback_margin=0.1)


def _controller(pkg, svc, **kw):
    return PKGS[pkg]["Controller"](svc, **{**_CTL, **kw})


def _inject_eval(svc, triples):
    """Append [label, primary, shadow] rows to the live shadow eval buffer
    — standing in for sampled traffic with exactly-known evidence."""
    with svc._shadow_lock:
        svc._shadow["eval"].extend([list(t) for t in triples])


def _evidence(n=16, pos=4, *, candidate_wins):
    rows = []
    for i in range(n):
        label = 1.0 if i < pos else 0.0
        good, bad = label, 1.0 - label
        rows.append([label, bad, good] if candidate_wins else [label, good, bad])
    return rows


def _state(svc, ctl) -> dict:
    st = svc.stats()
    return {"state": ctl.state, "candidate": ctl.candidate_version, "stats": dict(ctl.stats),
            "last": ctl.last_decision, "version": svc.model_version,
            "last_good": svc.last_good_version, "shadow": svc.shadow_stats(),
            "rollbacks": st.rollbacks, "last_rollback": svc.last_rollback}


def _both(world, scenario):
    """Run ``scenario(pkg, svc)`` on a port and a reference service; each
    returns (decisions, final state).  They must be equal; the port's is
    returned for the scenario's own checks."""
    out = {}
    for pkg in ("port", "ref"):
        svc = _build(world, pkg)
        try:
            out[pkg] = scenario(pkg, svc)
        finally:
            svc.close()
    assert out["port"] == out["ref"]
    return out["port"]


# --------------------------------------------------------- state transitions
def test_submit_candidate_enables_shadow(world):
    def scenario(pkg, svc):
        ctl = _controller(pkg, svc)
        v = ctl.submit_candidate(svc.model_params())
        with pytest.raises(RuntimeError, match="one candidate at a time"):
            ctl.submit_candidate(svc.model_params())
        return v, _state(svc, ctl)

    v, st = _both(world, scenario)
    assert st["state"] == "shadowing" and st["candidate"] == v
    assert st["shadow"]["role"] == "candidate" and st["shadow"]["version"] == v
    assert st["shadow"]["eval"] == [] and st["shadow"]["eval_max"] == 64
    assert st["stats"]["submitted"] == 1


def test_step_waits_for_min_evidence(world):
    def scenario(pkg, svc):
        ctl = _controller(pkg, svc)
        ctl.submit_candidate(svc.model_params())
        first = ctl.step()
        _inject_eval(svc, _evidence(n=8, pos=2, candidate_wins=True))
        return [first, ctl.step()], _state(svc, ctl)

    decisions, st = _both(world, scenario)
    assert decisions == [None, None] and st["state"] == "shadowing"


def test_promotes_on_margin_then_watches_then_clears(world):
    def scenario(pkg, svc):
        ctl = _controller(pkg, svc)
        ctl.submit_candidate(svc.model_params())
        _inject_eval(svc, _evidence(n=20, pos=5, candidate_wins=True))
        d1 = ctl.step()
        mid = _state(svc, ctl)
        _inject_eval(svc, _evidence(n=64, pos=8, candidate_wins=False))
        return [d1, mid, ctl.step()], _state(svc, ctl)

    (d1, mid, d2), st = _both(world, scenario)
    assert d1["action"] == "promote" and d1["incumbent"] == 0
    assert d1["candidate_recall"] == 1.0 and d1["incumbent_recall"] == 0.0
    assert d1["n_eval"] == 20
    assert mid["state"] == "watching" and mid["version"] == d1["candidate"]
    assert mid["shadow"]["role"] == "last_good" and mid["shadow"]["version"] == 0
    assert d2["action"] == "cleared"
    assert st["state"] == "idle" and st["shadow"] == {} and st["version"] == d1["candidate"]
    assert st["stats"] == {"submitted": 1, "promoted": 1, "rejected": 0, "rollbacks": 0,
                           "cleared": 1}


def test_rejects_when_margin_not_met(world):
    def scenario(pkg, svc):
        ctl = _controller(pkg, svc)
        ctl.submit_candidate(svc.model_params())
        _inject_eval(svc, _evidence(n=20, pos=5, candidate_wins=False))
        return ctl.step(), _state(svc, ctl)

    d, st = _both(world, scenario)
    assert d["action"] == "reject" and st["version"] == 0
    assert st["state"] == "idle" and st["shadow"] == {} and st["stats"]["rejected"] == 1


def test_rejects_when_the_eval_budget_runs_out(world):
    """The eval buffer fills before enough positives arrive: reject."""
    def scenario(pkg, svc):
        ctl = _controller(pkg, svc, eval_max=24, min_eval_pos=5)
        ctl.submit_candidate(svc.model_params())
        _inject_eval(svc, _evidence(n=24, pos=2, candidate_wins=False))
        return ctl.step(), _state(svc, ctl)

    d, st = _both(world, scenario)
    assert d["action"] == "reject" and d["n_pos"] == 2 and st["version"] == 0


def _enter_watching(pkg, svc, **ctl_kw):
    bad = svc.register_perturbed(0, scale=2.0)
    svc.activate_model(bad)
    svc.enable_shadow(0, fraction=1.0, threshold=10.0, collect_eval=64, role="last_good")
    ctl = PKGS[pkg]["Controller"].attach(svc, **{**_CTL, **ctl_kw})
    assert ctl.state == "watching" and ctl.candidate_version == bad
    return ctl, bad


def test_watch_rolls_back_on_recall_regression(world):
    def scenario(pkg, svc):
        ctl, bad = _enter_watching(pkg, svc)
        _inject_eval(svc, _evidence(n=20, pos=5, candidate_wins=True))
        return [bad, ctl.step()], _state(svc, ctl)

    (bad, d), st = _both(world, scenario)
    assert d["action"] == "rollback" and "recall regression" in d["reason"]
    assert d["restored"] == 0 and st["version"] == 0
    assert st["shadow"] == {} and st["state"] == "idle" and st["rollbacks"] == 1
    assert st["last_rollback"]["from"] == bad


def test_watch_rolls_back_on_divergence_alert(world):
    def scenario(pkg, svc):
        ctl, _bad = _enter_watching(pkg, svc)
        with svc._shadow_lock:
            svc._shadow["alert_active"] = True
            svc._shadow["divergence_max"] = 0.9
        return ctl.step(), _state(svc, ctl)

    d, st = _both(world, scenario)
    assert d["action"] == "rollback" and "divergence" in d["reason"]
    assert st["version"] == 0 and st["state"] == "idle" and st["stats"]["rollbacks"] == 1


def test_midstream_hotswap_steals_shadow(world):
    def scenario(pkg, svc):
        ctl = _controller(pkg, svc)
        ctl.submit_candidate(svc.model_params())
        _inject_eval(svc, _evidence(n=20, pos=5, candidate_wins=True))
        v9 = svc.register_perturbed(0, scale=0.0, version=9)
        svc.enable_shadow(v9, fraction=0.5)
        d = ctl.step()
        mid = _state(svc, ctl)
        ctl.submit_candidate(svc.model_params())
        return [d, mid], _state(svc, ctl)

    (d, mid), st = _both(world, scenario)
    assert d is None and mid["state"] == "idle" and mid["candidate"] is None
    assert mid["version"] == 0 and st["state"] == "shadowing"


def test_midstream_primary_hotswap_during_shadowing(world):
    def scenario(pkg, svc):
        ctl = _controller(pkg, svc)
        v = ctl.submit_candidate(svc.model_params())
        _inject_eval(svc, _evidence(n=10, pos=3, candidate_wins=True))
        v2 = svc.register_perturbed(0, scale=0.0, version=v + 7)
        svc.activate_model(v2)
        _inject_eval(svc, _evidence(n=10, pos=3, candidate_wins=True))
        return [v, v2, ctl.step()], _state(svc, ctl)

    (v, v2, d), st = _both(world, scenario)
    assert d["action"] == "promote" and d["incumbent"] == v2
    assert st["version"] == v and st["last_good"] == v2


# ------------------------------------------------- crash/restore mid-eval
def test_crash_mid_shadow_eval_resumes_without_double_count(world, tmp_path):
    """Each package writes its own root and restores it: the checkpointed
    window resumes once, the controller re-attaches mid-eval, fresh
    traffic fills the same window.  The port's restored eval buffer holds
    the reference's labels and its scores within 1e-5."""
    events = world[0]
    out = {}
    for pkg in ("port", "ref"):
        ns = PKGS[pkg]
        root = str(tmp_path / pkg)
        svc = _build(world, pkg).enable_wal(root)
        ctl = _controller(pkg, svc)
        cand = ctl.submit_candidate(svc.model_params())
        for ev in events[:12]:
            svc.shadow_observe(svc.submit(ev))
        svc.shadow_observe(svc.drain())
        n1 = len(svc.shadow_stats()["eval"])
        svc.checkpoint()
        for ev in events[12:16]:
            svc.shadow_observe(svc.submit(ev))
        eval_before = svc.shadow_stats()["eval"]
        svc2 = ns["FraudService"].restore(root, **ns["device"])
        sh = svc2.shadow_stats()
        assert n1 > 0 and len(sh["eval"]) == n1
        assert sh["eval"] == eval_before[:n1]
        assert sh["role"] == "candidate" and sh["version"] == cand
        ctl2 = ns["Controller"].attach(svc2, **_CTL)
        assert ctl2.state == "shadowing" and ctl2.candidate_version == cand
        for ev in events[16:20]:
            svc2.shadow_observe(svc2.submit(ev))
        svc2.shadow_observe(svc2.drain())
        out[pkg] = np.asarray(svc2.shadow_stats()["eval"])
        assert len(out[pkg]) > n1
        svc.close()
        svc2.close()
    assert out["port"].shape == out["ref"].shape
    np.testing.assert_array_equal(out["port"][:, 0], out["ref"][:, 0])
    np.testing.assert_allclose(out["port"][:, 1:], out["ref"][:, 1:], rtol=0, atol=1e-5)


def test_crash_mid_watch_restores_last_good_target(world, tmp_path):
    root = str(tmp_path / "wal")
    svc = _build(world, "port").enable_wal(root)
    _ctl, bad = _enter_watching("port", svc)
    svc.checkpoint()
    svc2 = FraudService.restore(root, device="cpu")
    assert svc2.model_version == bad and svc2.last_good_version == 0
    ctl2 = PromotionController.attach(svc2)
    assert ctl2.state == "watching"
    with svc2._shadow_lock:
        svc2._shadow["alert_active"] = True
    d = ctl2.step()
    assert d["action"] == "rollback" and svc2.model_version == 0
    svc.close()
    svc2.close()


# --------------------------------------------------------- the closed loop
_ATTACK = dict(num_buyers=60, num_rings=3, ring_size=5, num_snapshots=10, num_bursts=1,
               num_bin_runs=1, seed=0)


def _closed_loop(pkg, params, tmp_path):
    """The reference test's loop through one package: every decision's
    action, every fire's losses, the last promotion, the rollback."""
    if pkg == "port":
        events, _, _ = drifting_attack_stream(AttackConfig(**_ATTACK), rate_per_s=500.0)
        ns, Learner = PKGS["port"], ContinuousLearner
    else:
        events, _, _ = RL.drifting_attack_stream(RefAttackConfig(**_ATTACK), rate_per_s=500.0)
        ns, Learner = PKGS["ref"], RL.ContinuousLearner
    sc = ns["ServiceConfig"].from_dict({
        "mode": "streaming",
        "model": {"num_gnn_layers": 2, "hidden_dim": 8,
                  "feat_dim": int(events[0].features.shape[0]),
                  "mlp_dims": [8], "entity_types": list(ENTITY_TYPE_NAMES)},
        "engine": {"num_workers": 1, "max_batch": 8, "k_max": 4},
        "learn": {"enabled": True, "min_window": 32, "max_window": 128,
                  "stride": 32, "steps": 10, "lr": 1e-2, "min_eval": 16,
                  "min_eval_pos": 2, "eval_max": 64, "promote_margin": 0.0},
    })
    svc = ns["FraudService"](sc, params=params, **ns["device"]).build()
    svc.enable_wal(str(tmp_path / pkg))
    svc.enable_auto_checkpoint(every_windows=3, keep_last=2)
    learner = Learner(svc)
    fires = []
    train = learner.trainer.train

    def recording_train(p):
        res = train(p)
        fires.append(res.losses)
        return res

    learner.trainer.train = recording_train
    decisions = []
    for i, ev in enumerate(events):
        svc.shadow_observe(svc.submit(ev))
        if (i + 1) % 8 == 0:
            d = learner.step()["decision"]
            if d:
                decisions.append(d)
    svc.drain()
    promotions = [d for d in decisions if d["action"] == "promote"]
    assert promotions, "the loop never promoted a fine-tune"
    assert all(d["n_eval"] >= 16 and d["candidate_recall"] >= d["incumbent_recall"]
               for d in promotions)
    assert learner.tap.stats["examples"] >= len(events) - 8 - learner.tap.pending
    assert svc.stats().extra["auto_checkpoint"]["checkpoints"] >= 1
    promoted_v = svc.model_version
    assert promoted_v != 0

    rollbacks_before = svc.stats().rollbacks
    bad = svc.register_perturbed(promoted_v, scale=3.0)
    svc.activate_model(bad)
    svc.enable_shadow(promoted_v, fraction=1.0, threshold=0.05, collect_eval=64,
                      role="last_good")
    watcher = ns["Controller"].attach(svc, watch_min_eval=8, rollback_margin=0.05)
    assert watcher.state == "watching"
    rolled, fed = None, 0
    for ev in events[-40:]:
        ev2 = ev.__class__(order_id=ev.order_id + 9_000_000, snapshot=events[-1].snapshot,
                           entities=ev.entities, features=ev.features, label=ev.label,
                           arrival=ev.arrival)
        svc.shadow_observe(svc.submit(ev2))
        fed += 1
        rolled = watcher.step()
        if rolled is not None:
            break
    svc.drain()
    assert rolled is not None and rolled["action"] == "rollback"
    assert svc.model_version == promoted_v
    assert svc.stats().rollbacks == rollbacks_before + 1
    learner.close()
    svc.close()
    return {"actions": [(d["phase"], d["action"]) for d in decisions],
            "fires": fires, "promoted": promoted_v,
            "rollback": (rolled["reason"].split(" (")[0], bad, fed)}


def test_closed_loop_drift_finetune_promote_rollback(tmp_path):
    """The acceptance path through public APIs, on both packages from the
    same weights: the first fine-tune's losses within 1e-5 relative, the
    same actions in the same order, the same promotee, and the injected
    regression rolled back after the same number of events."""
    ref_cfg = R.LNNConfig(num_gnn_layers=2, hidden_dim=8,
                          feat_dim=int(RL.drifting_attack_stream(
                              RefAttackConfig(**_ATTACK))[0][0].features.shape[0]),
                          mlp_dims=(8,), entity_types=ENTITY_TYPE_NAMES)
    ref_params = R.lnn_init(jax.random.PRNGKey(0), ref_cfg)
    port = _closed_loop("port", _to_port(ref_params), tmp_path)
    ref = _closed_loop("ref", ref_params, tmp_path)
    assert len(port["fires"]) >= 1 and len(port["fires"][0]) == 10
    np.testing.assert_allclose(port["fires"][0], ref["fires"][0], rtol=LOSS_RTOL, atol=0)
    assert port["actions"] == ref["actions"]
    assert ("shadowing", "promote") in port["actions"]
    assert port["promoted"] == ref["promoted"]
    assert port["rollback"] == ref["rollback"]

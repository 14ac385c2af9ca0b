"""The paper's configuration and serving launcher in the port, on the CPU:
``configs.get_config("lnn_fraud")`` equals the reference's ``LNNConfig``
field for field, its ``SERVICE``/``SERVICE_BATCH`` artifacts serialize to
the reference's JSON text, ``all_configs`` returns every zoo id with the
reference's values, and ``launch.serve.serve_paper`` with the reference's
parameters scores the reference's requests within 1e-5 (f32 on both sides,
summed in another order) with an equivalence gap within the reference's
1e-4."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as RCF
import repro.configs.lnn_fraud as ref_lnn_fraud
import repro.core as R
import repro.data as RD
import repro.serve as RS
from repro.data.pipeline import standardize_features as ref_standardize
from repro_torch.configs import all_configs, get_config
from repro_torch.configs import lnn_fraud
from repro_torch.launch import serve as serve_mod
from repro_torch.params import from_numpy

SCORE_TOL = 1e-5
EQUIV_ATOL = 1e-4


def test_lnn_fraud_config_equals_reference():
    ref = RCF.get_config("lnn_fraud")
    port = get_config("lnn_fraud")
    assert port is lnn_fraud.CONFIG
    # the port's LNNConfig has every field but ``use_pallas`` (the card's
    # kernels are chosen by the tensors' device, not by a flag)
    want = dataclasses.asdict(ref)
    assert want.pop("use_pallas") is False
    assert dataclasses.asdict(port) == want


@pytest.mark.parametrize("name", ["SERVICE", "SERVICE_BATCH"])
def test_lnn_fraud_service_artifacts_equal_reference_json(name):
    port, ref = getattr(lnn_fraud, name), getattr(ref_lnn_fraud, name)
    assert port.to_json() == ref.to_json()
    assert port.to_lnn_config() == lnn_fraud.CONFIG


def test_all_configs_refuses_a_subset():
    """Every zoo id is ported: ``all_configs()`` returns all ten, each equal
    field for field to the reference's; an unknown id raises ``KeyError``."""
    port, ref = all_configs(), RCF.all_configs()
    assert len(port) == 10 and port.keys() == ref.keys()
    for aid, cfg in port.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[aid]), aid
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_serve_paper(users, requests, seed, params):
    """The reference's ``serve_paper`` steps with ``params``, returning its
    per-request scores and equivalence gap (its launcher only prints)."""
    g, _ = RD.generate_transactions(RD.SynthConfig(num_users=users, num_rings=6,
                                                   feature_noise=0.8, seed=seed))
    split = RD.make_split_masks(g.order_snapshot)
    g.order_features, _ = ref_standardize(g.order_features, split == 0)
    batches = RD.build_communities(g, community_size=256, max_deg=24)
    cfg = R.LNNConfig(num_gnn_layers=3, hidden_dim=64, feat_dim=g.order_features.shape[1])
    store = RS.KVStore(cfg.hidden_dim)
    RS.BatchLayer(params, cfg, store).refresh(batches)
    speed = RS.SpeedLayer(params, cfg, store, k_max=8)
    gap = RS.split_equivalence_check(speed.score, params, cfg, batches)
    reqs = RS.history_requests(batches)[:requests]
    return cfg, np.asarray([speed.score([r])[0] for r in reqs], np.float32), gap


def test_serve_paper_matches_reference(one_thread):
    users, requests, seed = 150, 48, 3
    probe = RD.generate_transactions(RD.SynthConfig(num_users=users, num_rings=6,
                                                    feature_noise=0.8, seed=seed))[0]
    ref_cfg = R.LNNConfig(num_gnn_layers=3, hidden_dim=64,
                          feat_dim=probe.order_features.shape[1])
    ref_params = R.lnn_init(jax.random.PRNGKey(seed), ref_cfg)
    cfg, want, ref_gap = _reference_serve_paper(users, requests, seed, ref_params)
    assert cfg == ref_cfg
    out = serve_mod.serve_paper(users, requests, seed, device="cpu",
                                params=from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                                                  "cpu"))
    assert out["requests"] == requests == len(want)
    np.testing.assert_allclose(out["scores"], want, atol=SCORE_TOL, rtol=SCORE_TOL)
    assert out["equivalence_gap"] <= EQUIV_ATOL and ref_gap <= EQUIV_ATOL
    assert out["refresh"]["entities_written"] > 0
    lat = out["latency_ms"]
    assert 0.0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    # its own seeded weights, and the card by default (none here: it raises)
    own = serve_mod.serve_paper(users, 4, seed, device="cpu")
    assert own["scores"].shape == (4,) and np.isfinite(own["scores"]).all()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.serve_paper(users, 4, seed)


def test_launcher_defaults_to_the_paper_and_still_serves_the_zoo(one_thread, capsys):
    serve_mod.main(["--device", "cpu", "--users", "60", "--requests", "8"])
    out = capsys.readouterr().out
    assert "split equivalence:" in out and "speed layer over 8 checkouts: p50=" in out
    serve_mod.main(["--arch", "zamba2-1.2b", "--device", "cpu", "--batch", "1", "--seq", "8",
                    "--tokens", "2"])
    out = capsys.readouterr().out
    assert "prefill 1x8:" in out and "decoded 2 tokens x 1 seqs" in out and "sample ids:" in out
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.main(["--paper", "--users", "60", "--requests", "2"])

"""The port's training launcher (``repro_torch.launch.train``) and tree
helpers (``repro_torch.utils.tree``) on the CPU: ``train_arch`` (a reduced
zoo config, two steps) and ``train_paper`` (a tiny world, one epoch), each
run in a temporary working directory, write checkpoints that the
reference's ``load_checkpoint`` reads; the CLI's ``--arch`` and
``--paper``; and the tree helpers against the reference's on the same
tree."""
import argparse
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import LNNConfig as RefLNNConfig
from repro.core import lnn_init as ref_lnn_init
from repro.models import transformer as RT
from repro.train.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.train.optim import adamw as ref_adamw
from repro.utils import tree as RTree
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.train.optim import adamw
from repro_torch.utils import tree as TTree


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    base = dict(paper=False, gnn="gcn", arch="zamba2-1.2b", reduced=True, steps=2, epochs=1,
                batch=2, seq=32, lr=3e-4, users=60, rings=6, seed=0, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "seamless-m4t-medium"])
def test_train_arch_writes_a_checkpoint_the_reference_reads(arch, tmp_path, monkeypatch,
                                                            capsys):
    monkeypatch.chdir(tmp_path)
    out = launch_train.train_arch(_args(arch=arch))
    assert len(out["loss"]) == len(out["grad_norm"]) == len(out["step_s"]) == 2
    assert all(math.isfinite(v) for v in out["loss"] + out["grad_norm"])
    np.testing.assert_allclose(out["lr"], [3e-4 / 500, 2 * 3e-4 / 500], rtol=1e-6)
    ckpt = tmp_path / "checkpoints" / f"{arch.replace('.', '_')}.npz"
    assert out["checkpoint"] == f"checkpoints/{arch.replace('.', '_')}.npz"
    like = RT.init_params(jax.random.PRNGKey(0), ref_get_config(arch).reduced())
    tree, step = ref_load_checkpoint(str(ckpt), like)
    assert step == 2
    got = dict(P.flatten_paths(jax.tree_util.tree_map(np.asarray, tree)))
    mine = dict(P.flatten_paths(P.load_npz(str(ckpt), "cpu")))
    assert got.keys() == mine.keys()
    assert all(np.array_equal(got[k], mine[k].numpy()) for k in got)
    printed = capsys.readouterr().out
    assert "step 0: loss=" in printed and "final loss" in printed


def test_arch_batch_draws_as_the_reference_does():
    cfg = get_config("llama-3.2-vision-90b").reduced()
    got = launch_train.arch_batch(cfg, 2, 16, np.random.default_rng(7), "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 17))
    vision = rng.normal(size=(2, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    assert np.array_equal(got["tokens"].numpy(), toks[:, :-1])
    assert np.array_equal(got["labels"].numpy(), toks[:, 1:])
    assert np.array_equal(got["vision"].numpy(), vision) and "frames" not in got
    audio = launch_train.arch_batch(get_config("seamless-m4t-medium").reduced(), 1, 100,
                                    np.random.default_rng(0), "cpu")
    assert audio["frames"].shape[1] == 64 and audio["tokens"].dtype == torch.int32


def test_train_paper_writes_a_checkpoint_the_reference_reads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    metrics = launch_train.train_paper(_args(paper=True, arch=None, epochs=1))
    assert {"roc_auc", "average_precision"} <= set(metrics)
    port = P.load_npz(str(tmp_path / "checkpoints" / "lnn_gcn.npz"), "cpu")
    like = ref_lnn_init(jax.random.PRNGKey(0), RefLNNConfig(
        gnn_type="gcn", num_gnn_layers=3, hidden_dim=64, pos_weight=3.0,
        feat_dim=port["input"]["w"].shape[0]))
    tree, _ = ref_load_checkpoint(str(tmp_path / "checkpoints" / "lnn_gcn.npz"), like)
    got = dict(P.flatten_paths(jax.tree_util.tree_map(np.asarray, tree)))
    mine = dict(P.flatten_paths(port))
    assert got.keys() == mine.keys()
    assert all(np.array_equal(got[k], mine[k].numpy()) for k in got)


def test_cli_trains_on_cpu_when_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    launch_train.main(["--arch", "mamba2-370m", "--steps", "1", "--seq", "16", "--batch", "1",
                       "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    assert (tmp_path / "checkpoints" / "mamba2-370m.npz").exists()


def _tree_pair():
    cfg = ref_get_config("phi3.5-moe-42b-a6.6b").reduced()
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    opt = ref_adamw(1e-3)[0](params)
    tree = {"params": params, "opt": opt, "pair": [params["final_ln"], params["embed"]]}
    tparams = P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ttree = {"params": tparams, "opt": adamw(1e-3)[0](tparams),
             "pair": [tparams["final_ln"], tparams["embed"]]}
    return tree, ttree


def test_tree_size_and_bytes_match_reference():
    tree, ttree = _tree_pair()
    assert TTree.tree_size(ttree) == RTree.tree_size(tree)
    assert TTree.tree_bytes(ttree) == RTree.tree_bytes(tree)
    half = P.tree_map(lambda t: t.to(torch.bfloat16), ttree["params"])
    assert TTree.tree_bytes(half) == RTree.tree_bytes(tree["params"]) // 2
    assert TTree.tree_size(torch.zeros(3, 4, device="meta")) == 12


def test_tree_zeros_like_and_map_with_path_match_reference():
    tree, ttree = _tree_pair()
    zeros = TTree.tree_zeros_like(ttree["params"])
    assert all(not z.any() and z.shape == t.shape and z.dtype == t.dtype
               for z, t in zip(P.tree_leaves(zeros), P.tree_leaves(ttree["params"])))
    want = RTree.tree_map_with_path(lambda p, x: p, {"params": tree["params"],
                                                     "pair": tree["pair"]})
    got = TTree.tree_map_with_path(lambda p, x: p, {"params": ttree["params"],
                                                    "pair": ttree["pair"]})
    assert sorted(P.tree_leaves(got)) == sorted(jax.tree_util.tree_leaves(want))
    assert got["params"]["groups"]["decoder"]["moe"]["router"] == \
        "params/groups/decoder/moe/router"
    assert got["pair"][1] == "pair/1"
    named = TTree.tree_map_with_path(lambda p, x: p, ttree["opt"])
    assert named.mu["embed"] == "mu/embed" and named.step == "step"

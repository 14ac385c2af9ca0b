"""The PyTorch/CUDA port stands alone: it imports neither JAX nor the
reference package, its entry points default to the card and raise without
one, and its CUDA wrappers and ``chip_smoke.py`` refuse to run off the card
instead of falling back to the plain path."""
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import LNNConfig, lnn_init
from repro_torch.core.graph import COOGraph, pad_graph
from repro_torch.kernels import _build, ops
from repro_torch.baselines import MLPConfig, mlp_init, train_mlp
from repro_torch.kernels.csr_spmm import (csr_spmm_bwd_cuda, csr_spmm_cuda,
                                          csr_spmm_etype_mean_bwd_cuda, csr_spmm_etype_mean_cuda)
from repro_torch.configs import get_config
from repro_torch.gateway import serve_gateway
from repro_torch.learn import ContinuousLearner, RollingWindowTrainer
from repro_torch.kernels.edge_softmax import edge_softmax_agg_bwd_cuda, edge_softmax_agg_cuda
from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from repro_torch.kernels.gqa_decode import gqa_decode_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.stage2_score import stage2_score_cuda
from repro_torch.launch import serve as zoo_serve
from repro_torch.launch import train as zoo_train
from repro_torch.models import init_cache, init_params
from repro_torch.models.hybrid import train_hybrid
from repro_torch.params import from_numpy, to_numpy
from repro_torch.serve import BatchLayer, KVStore, SpeedLayer
from repro_torch.service import FraudService, ModelSection, ServiceConfig, build_service
from repro_torch.stream import (CheckoutEvent, EngineConfig, ProcessWorkerPool, RefreshDriver,
                                ShardServer, Stage2Scorer, StreamingEngine, StreamIngester,
                                WorkerPool)
from repro_torch.train.loop import evaluate_lnn, train_lnn

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_REFERENCE_IMPORT = re.compile(r"^\s*(from|import)\s+(repro|jax)(\.|\s|$)", re.M)


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_import_loads_neither_jax_nor_reference():
    code = ("import importlib, json, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_reference_or_jax(path):
    assert not _REFERENCE_IMPORT.search(path.read_text())


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def zoo_train_args(**kw):
    """The launcher's argument namespace, parsed from no arguments (the
    reference's defaults), with ``kw`` set on it."""
    args = zoo_train.argparse.Namespace(
        paper=False, gnn="gcn", arch="zamba2-1.2b", reduced=True, steps=1, epochs=1, batch=1,
        seq=8, lr=3e-4, users=60, rings=6, seed=0)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _tiny_graph():
    g = COOGraph(num_nodes=3, src=np.array([1, 2]), dst=np.array([0, 0]),
                 etype=np.array([3, 3], np.int32), features=np.ones((3, 2)),
                 node_type=np.array([0, 2, 2]), snapshot=np.zeros(3),
                 label=np.zeros(3), label_mask=np.zeros(3))
    return pad_graph(g)


@pytest.mark.parametrize("entry", ["lnn_init", "from_numpy", "BatchLayer",
                                   "SpeedLayer", "PaddedGraph.to", "zoo init_params",
                                   "zoo init_cache", "zoo serve", "zoo serve main",
                                   "train_lnn", "evaluate_lnn", "mlp_init", "train_mlp",
                                   "StreamingEngine", "RefreshDriver", "Stage2Scorer",
                                   "WorkerPool", "FraudService", "FraudService.restore",
                                   "FraudService.from_artifact", "build_service",
                                   "train_hybrid", "ProcessWorkerPool", "ShardServer",
                                   "serve_paper", "paper serve main",
                                   "RollingWindowTrainer", "serve_gateway",
                                   "serve_gateway restore", "train_arch", "zoo train main",
                                   "train_paper", "paper train main"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, no_cuda, tmp_path,
                                                           monkeypatch):
    monkeypatch.chdir(tmp_path)    # the launchers write checkpoints/ under the cwd
    cfg = LNNConfig(hidden_dim=4, mlp_dims=(4,), feat_dim=2)
    zoo = get_config("zamba2-1.2b").reduced()
    calls = {
        "lnn_init": lambda: lnn_init(torch.Generator().manual_seed(0), cfg),
        "from_numpy": lambda: from_numpy({"w": np.zeros(2)}),
        "BatchLayer": lambda: BatchLayer({}, cfg, KVStore(4)),
        "SpeedLayer": lambda: SpeedLayer({}, cfg, KVStore(4)),
        "PaddedGraph.to": lambda: _tiny_graph().to(),
        "zoo init_params": lambda: init_params(torch.Generator().manual_seed(0), zoo),
        "zoo init_cache": lambda: init_cache(zoo, 1, 8),
        "zoo serve": lambda: zoo_serve.serve(zoo, 1, 8, 1),
        "zoo serve main": lambda: zoo_serve.main(["--arch", "zamba2-1.2b"]),
        "train_lnn": lambda: train_lnn([], np.zeros(0, np.int32), cfg),
        "evaluate_lnn": lambda: evaluate_lnn({}, cfg, [], np.zeros(0, np.int32)),
        "mlp_init": lambda: mlp_init(torch.Generator().manual_seed(0), 3, MLPConfig()),
        "train_mlp": lambda: train_mlp(np.zeros((4, 3)), np.zeros(4), np.zeros((2, 3)),
                                       np.zeros(2)),
        "StreamingEngine": lambda: StreamingEngine({}, cfg),
        "RefreshDriver": lambda: RefreshDriver({}, cfg, KVStore(4), StreamIngester(2)),
        "Stage2Scorer": lambda: Stage2Scorer({}, cfg, KVStore(4), 8),
        "WorkerPool": lambda: WorkerPool({}, cfg, KVStore(4)),
        "FraudService": lambda: FraudService(ServiceConfig()),
        "FraudService.restore": lambda: FraudService.restore(str(tmp_path)),
        "FraudService.from_artifact": lambda: FraudService.from_artifact(artifact),
        "build_service": lambda: build_service(ServiceConfig(), {}),
        "train_hybrid": lambda: train_hybrid({"w": np.zeros(2)}, cfg, np.zeros((4, 2)),
                                             np.array([0.0, 1.0, 0.0, 1.0])),
        "ProcessWorkerPool": lambda: ProcessWorkerPool({}, cfg, dict(dim=4)),
        "ShardServer": lambda: ShardServer(0, cfg, dict(dim=4), 8, 4, "v0.npz", 0),
        "serve_paper": lambda: zoo_serve.serve_paper(60, 2),
        "paper serve main": lambda: zoo_serve.main([]),
        "RollingWindowTrainer": lambda: RollingWindowTrainer(cfg),
        "serve_gateway": lambda: serve_gateway(ServiceConfig(), {}),
        "serve_gateway restore": lambda: serve_gateway(
            ServiceConfig(gateway={"checkpoint_dir": str(tmp_path)}), None),
        "train_arch": lambda: zoo_train.train_arch(zoo_train_args()),
        "zoo train main": lambda: zoo_train.main(["--arch", "zamba2-1.2b", "--steps", "1"]),
        "train_paper": lambda: zoo_train.train_paper(zoo_train_args(arch=None, paper=True)),
        "paper train main": lambda: zoo_train.main(["--paper", "--users", "60"]),
    }
    artifact = str(tmp_path / "service.json")
    ServiceConfig().save(artifact)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_entry_points_run_on_cpu_when_asked(no_cuda, tmp_path):
    cfg = LNNConfig(hidden_dim=4, mlp_dims=(4,), feat_dim=2)
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["input"]["w"].device.type == "cpu"
    g = _tiny_graph().to("cpu")
    assert g.nbr_idx.dtype == torch.int32 and g.tower is None
    assert BatchLayer(params, cfg, KVStore(4), device="cpu").device.type == "cpu"
    eng = StreamingEngine(params, cfg, EngineConfig(num_workers=2), device="cpu")
    assert eng.device.type == eng.pool.device.type == eng.refresher.device.type == "cpu"
    assert all(w.scorer.device.type == "cpu" for w in eng.pool.workers)
    assert RefreshDriver(params, cfg, KVStore(4), StreamIngester(2),
                         device="cpu").device.type == "cpu"
    sc = Stage2Scorer(params, cfg, KVStore(4), 8, device="cpu")
    probs, stale, version = sc(np.zeros((2, 2), np.float32), [[], []])
    assert probs.shape == (2,) and version == 0 and (stale == -1).all()
    assert WorkerPool(params, cfg, KVStore(4), device="cpu").device.type == "cpu"
    sc = ServiceConfig(model=ModelSection.from_lnn_config(cfg))
    svc = build_service(sc, params, device="cpu")
    assert svc.device.type == svc.engine.device.type == "cpu"
    hy = train_hybrid(to_numpy(params), cfg, np.zeros((4, 6)), np.array([0.0, 1, 0, 1]),
                      device="cpu")
    assert hy.lnn_params["input"]["w"].device.type == "cpu"
    assert RollingWindowTrainer(cfg, device="cpu").device.type == "cpu"
    # the learn plane runs where its service runs (CUDA by default, above)
    svc.enable_wal(str(tmp_path / "wal"))
    learner = ContinuousLearner(svc)
    assert learner.trainer.device.type == "cpu"
    learner.close()
    svc.close()
    gw = serve_gateway(sc, params, warmup=False, device="cpu")
    gw.close()
    assert gw.service.device.type == "cpu"


def test_streaming_refuses_what_comes_with_the_service_layer():
    """The process backend builds and scores (its shard processes on the
    CPU when asked, as the engine is); a hybrid model that is not the
    port's ``HybridModel`` (the reference's surface) raises ``TypeError``;
    an unknown backend raises ``ValueError``."""
    cfg = LNNConfig(hidden_dim=4, mlp_dims=(4,), feat_dim=2)
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    proc = StreamingEngine(params, cfg, EngineConfig(backend="process"), device="cpu")
    try:
        assert isinstance(proc.pool, ProcessWorkerPool) and proc.pool.ping() == [0]
        ev = CheckoutEvent(order_id=0, snapshot=0, entities=(1, 2),
                           features=np.ones(2, np.float32), label=0.0, arrival=0.0)
        out = proc.submit(ev) + proc.flush()
        assert len(out) == 1 and 0.0 <= out[0].score <= 1.0 and out[0].staleness == -1
    finally:
        proc.close()

    class Hybrid:                    # the reference HybridModel's surface
        lnn_params = params
        gbdt = None

    with pytest.raises(TypeError, match="HybridModel.*load_hybrid"):
        StreamingEngine(Hybrid(), cfg, device="cpu")
    eng = StreamingEngine(params, cfg, device="cpu")
    with pytest.raises(TypeError, match="HybridModel"):
        eng.load_model(Hybrid())
    with pytest.raises(ValueError, match="unknown workers backend"):
        StreamingEngine(params, cfg, EngineConfig(backend="thread"), device="cpu")


def test_direct_engine_construction_is_deprecated():
    """As in the reference: the facade passes ``_via_service=True``; any
    other construction warns and names the facade."""
    cfg = LNNConfig(hidden_dim=4, mlp_dims=(4,), feat_dim=2)
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.warns(DeprecationWarning, match="FraudService"):
        StreamingEngine(params, cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        StreamingEngine(params, cfg, device="cpu", _via_service=True)
        FraudService(ServiceConfig(model=ModelSection.from_lnn_config(cfg)), params,
                     device="cpu").build()


def test_launch_counter_is_exact_across_threads():
    """8 threads count 10,000 launches each under a short switch interval:
    the counter reads exactly 80,000."""
    before = dict(_build.LAUNCHES)

    def count():
        for _ in range(10_000):
            _build.check_launch(0, "ssd_scan")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launches()
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert _build.LAUNCHES["ssd_scan"] == 80_000
        assert sum(_build.LAUNCHES.values()) == 80_000
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(before)
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        _build.check_launch(2, "ssd_scan")
    assert _build.LAUNCHES == before


def test_first_load_builds_once_across_threads(monkeypatch, tmp_path):
    """Threads that ask for the kernel library together build it once; the
    others wait for that build and load its result."""
    builds = []
    started = threading.Event()

    def fake_compile(sources, out):
        builds.append(out)
        started.set()
        threading.Event().wait(0.2)          # a build takes a while
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"")
        return "log"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_declare", lambda lib: None)
    _build._load_library.cache_clear()
    try:
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(_build.load_library()))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and started.is_set()
        assert len(builds) == 1 and len(libs) == 8
        assert len({id(lib) for lib in libs}) == 1 and libs[0].built
    finally:
        _build._load_library.cache_clear()


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never runs the plain version in the kernel's place."""
    h = torch.zeros(4, 3)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    w = torch.zeros(4, 2)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmm_cuda(h, idx, w)
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmm_etype_mean_cuda(h, idx, w, idx, 4)
    with pytest.raises(ValueError, match="CUDA"):
        edge_softmax_agg_cuda(h, h[:, 0].contiguous(), h[:, 0].contiguous(), idx, w, w)
    with pytest.raises(ValueError, match="CUDA"):
        stage2_score_cuda(torch.zeros(2, 3, 4), torch.zeros(2, 3), torch.zeros(2, 5), ())
    ptr, slot = torch.zeros(5, dtype=torch.int32), torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmm_bwd_cuda(h, w, ptr, slot)
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmm_etype_mean_bwd_cuda(torch.zeros(4, 4, 3), w, idx, ptr, slot)
    with pytest.raises(ValueError, match="CUDA"):
        edge_softmax_agg_bwd_cuda(h, h, torch.zeros(4, 2), h, h[:, 0].contiguous(),
                                  h[:, 0].contiguous(), idx, w, w, ptr, slot)
    assert _build.LAUNCHES == before


def test_grad_guard_refuses_a_gradient_it_cannot_give():
    """The guard that ``stage2_score`` and ``gqa_decode`` run on the card,
    which have no backward kernel (``ssd_scan`` and ``flash_attention`` have
    theirs): it raises when autograd would want a gradient through them,
    and only then."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="gqa_decode has no backward kernel.*torch.no_grad"):
        ops.refuse_grad("gqa_decode", torch.zeros(2), x)
    with torch.no_grad():
        ops.refuse_grad("gqa_decode", x)
    ops.refuse_grad("gqa_decode", torch.zeros(3), None, torch.zeros(2, dtype=torch.int32))
    ops.refuse_grad("gqa_decode", x.detach())


@pytest.mark.parametrize("kernel", ["ssd_scan", "flash_attention", "gqa_decode",
                                    "ssd_scan_bwd", "flash_attention_bwd"])
def test_zoo_cuda_wrappers_refuse_cpu_tensors(kernel):
    x = torch.zeros(1, 64, 2, 64)
    dt, a, bc = torch.zeros(1, 64, 2), torch.zeros(2), torch.zeros(1, 64, 16)
    q = torch.zeros(1, 2, 64)
    calls = {
        "ssd_scan": lambda: ssd_scan_cuda(x, dt, a, bc, bc),
        "flash_attention": lambda: flash_attention_cuda(x, x, x),
        "gqa_decode": lambda: gqa_decode_cuda(q, x, x),
        "ssd_scan_bwd": lambda: ssd_scan_bwd_cuda(x, dt, a, bc, bc, a, x),
        "flash_attention_bwd": lambda: flash_attention_bwd_cuda(
            x, x, x, x, x, torch.zeros(1, 64, 2)),
    }
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        calls[kernel]()
    assert _build.LAUNCHES == before


def test_zoo_serves_on_cpu_when_asked(no_cuda, capsys):
    out = zoo_serve.serve(get_config("mamba2-370m").reduced(), 2, 8, 2, seed=0,
                          device="cpu")
    assert tuple(out["token_ids"].shape) == (2, 3) and out["all_finite"]
    zoo_serve.main(["--arch", "zamba2-1.2b", "--batch", "1", "--seq", "8",
                    "--tokens", "1", "--device", "cpu"])
    assert "decoded 1 tokens x 1 seqs" in capsys.readouterr().out


class _Elsewhere(torch.Tensor):
    """A tensor that claims a device with no kernel path (no storage)."""

    @staticmethod
    def __new__(cls, *shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)


def test_dispatch_raises_for_other_devices():
    h = _Elsewhere(4, 3)
    idx, w = _Elsewhere(4, 2, dtype=torch.int32), _Elsewhere(4, 2)
    with pytest.raises(ValueError, match="no kernel path"):
        ops.csr_spmm(h, idx, w)
    with pytest.raises(ValueError, match="no kernel path"):
        ops.csr_spmm_etype_mean(h, idx, w, idx, 4)
    q, q1 = _Elsewhere(1, 2, 8, 64), _Elsewhere(1, 2, 64)
    for call in (lambda: ops.flash_attention(q, q, q), lambda: ops.gqa_decode(q1, q, q),
                 lambda: ops.ssd_scan(q, q, q, q, q)):
        with pytest.raises(ValueError, match="no kernel path"):
            call()


def test_dispatch_takes_plain_version_for_meta_tensors():
    """A meta tensor (the dry-run's) takes the plain version, as a CPU one:
    the outputs' shapes and dtypes, no launch, under grad too."""
    before = dict(_build.LAUNCHES)
    h = torch.zeros(4, 3, device="meta")
    out = ops.csr_spmm(h, torch.zeros(4, 2, dtype=torch.int32, device="meta"),
                       torch.zeros(4, 2, device="meta"))
    assert (out.device.type, tuple(out.shape)) == ("meta", (4, 3))
    q = torch.empty(2, 4, 64, 64, device="meta", requires_grad=True)
    k = torch.empty(2, 2, 64, 64, device="meta", requires_grad=True)
    out = ops.flash_attention(q, k, k)
    assert (out.device.type, tuple(out.shape)) == ("meta", (2, 4, 64, 64))
    out.sum().backward()
    assert tuple(q.grad.shape) == tuple(q.shape) and tuple(k.grad.shape) == tuple(k.shape)
    dec = ops.gqa_decode(torch.empty(2, 4, 64, device="meta"), k.detach(), k.detach(),
                         kv_len=torch.empty(2, dtype=torch.int32, device="meta"))
    assert tuple(dec.shape) == (2, 4, 64)
    x = torch.empty(2, 128, 4, 16, device="meta")
    y = ops.ssd_scan(x, torch.empty(2, 128, 4, device="meta"), torch.empty(4, device="meta"),
                     torch.empty(2, 128, 8, device="meta"), torch.empty(2, 128, 8, device="meta"))
    assert (y.device.type, tuple(y.shape)) == ("meta", (2, 128, 4, 16))
    assert _build.LAUNCHES == before


def test_dryrun_import_starts_no_group_and_sets_no_environment():
    """Importing the dry-run (and the mesh, specs and roofline modules) in a
    fresh interpreter starts no process group, changes no environment
    variable and loads neither jax nor the reference package."""
    code = ("import json, os, sys\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "import repro_torch.launch.specs, repro_torch.launch.roofline\n"
            "import torch.distributed as dist\n"
            "print(json.dumps([dist.is_initialized(), dict(os.environ) == before,\n"
            "                  sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "                         ('jax', 'jaxlib', 'repro'))]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False, True, []]


def test_dispatch_takes_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 5, (5, 2)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(size=(5, 2)).astype(np.float32))
    before = dict(_build.LAUNCHES)
    out = ops.csr_spmm(h, idx, w)
    want = (h.numpy()[idx.numpy()] * w.numpy()[..., None]).sum(1)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6)
    assert _build.LAUNCHES == before


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: the smoke run exits non-zero and prints no result line,
    from the repository and from a directory holding only the script."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, env=env, cwd=script.parent, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

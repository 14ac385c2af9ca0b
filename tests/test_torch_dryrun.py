"""The port's dry-run tools on the CPU (``repro_torch.launch.{mesh,steps,
roofline,dryrun}``): reduced configurations of every group of the zoo over
small fake device meshes (a ``DeviceMesh`` on a fake process group, meta
``DTensor`` arguments), the counts held against the same step on meta and
on real CPU tensors without a mesh and against the affine extrapolation;
the one-device mesh's steps against the one-card entry points bit for bit;
``run_one``'s records; and ``dense_init`` on meta drawing nothing.

Every fake group is ended before its test returns (``fake_mesh`` and
``production_mesh`` are context managers), so the worker's process is left
without one."""
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_mesh, make_host_mesh, make_production_mesh,
                                     production_mesh, release_production_mesh)
from repro_torch.launch.roofline import StepCounter
from repro_torch.launch.serve import serve, serve_inputs
from repro_torch.launch.steps import make_step, make_train_step
from repro_torch.models import init_cache, init_params
from repro_torch.models.common import dense_init
from repro_torch.models.config import InputShape
from repro_torch.params import flatten_paths, tree_leaves, tree_map
from repro_torch.train.optim import adamw

#: a reduced configuration of every group: mamba, zamba_super, decoder (dense
#: and MoE, the latter expert-parallel on a 2-wide model axis), vlm_super, enc/dec
GROUPS = ["mamba2-370m", "zamba2-1.2b", "granite-3-2b", "phi3.5-moe-42b-a6.6b",
          "llama-3.2-vision-90b", "seamless-m4t-medium"]
SHAPES = {"train": InputShape("tiny_train", 64, 2, "train"),
          "prefill": InputShape("tiny_prefill", 64, 2, "prefill"),
          "decode": InputShape("tiny_decode", 64, 2, "decode")}
_PAD = ("pad_heads_to", "pad_kv_heads_to", "pad_vocab_to_multiple")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    release_production_mesh()
    assert not dist.is_initialized()


def _kw(kind):
    return {"train": {"use_remat": True}, "prefill": {}, "decode": {}}[kind]


def _real(tree):
    """A meta tree as CPU tensors of the same shapes and dtypes (zeros: the
    counts do not depend on the values)."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def _count(fn, args):
    with StepCounter() as counter:
        fn(*args)
    return counter.cost()


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", GROUPS)
def test_counts_agree_on_mesh_meta_cpu_and_extrapolation(arch, kind):
    """On a 2x2 mesh: the FLOPs of the sharded step equal those of the same
    step on meta and on real CPU tensors without a mesh, and the 1- and
    2-unit extrapolation equals the direct count (FLOPs, bytes and every
    collective).  (A 2x2x2 mesh works too, but ``DTensor``'s choice among
    its strategies on three mesh axes takes minutes per step.)"""
    shape = SHAPES[kind]
    cfg = get_config(arch).reduced().with_padding(2)
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        fn, args = make_step(cfg, mesh, shape, **_kw(kind))
        sharded = _count(fn, args)
        extrapolated = dryrun._extrapolated_cost(shape, mesh, cfg, serve_mode="serve")
    assert sharded["coll"]["counts"]["all-gather"] + sharded["coll"]["counts"]["all-reduce"] > 0
    fn, args = make_step(cfg, make_host_mesh("meta"), shape, **_kw(kind))
    meta = _count(fn, args)
    cpu = _count(make_step(cfg, make_host_mesh("cpu"), shape, **_kw(kind))[0], _real(args))
    assert sharded["flops"] == meta["flops"] == cpu["flops"] > 0
    assert meta["bytes"] == cpu["bytes"]
    assert sum(meta["coll"]["counts"].values()) == 0
    assert extrapolated == sharded


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "olmo-1b"])
def test_host_mesh_train_step_equals_make_train_step(arch):
    """The counterpart of the reference's test_sharded_train_step_single_device:
    ``make_step``'s train step on a one-device CPU mesh runs one real step,
    bit for bit the one-card ``make_train_step``'s."""
    cfg = get_config(arch).reduced()
    shape = InputShape("tiny_train", 16, 2, "train")
    mesh = make_host_mesh("cpu")
    fn, args = make_step(cfg, mesh, shape, use_remat=False)
    assert [tuple(t.shape) for t in tree_leaves(args[0])] == \
        [tuple(t.shape) for t in tree_leaves(init_params(torch.Generator(), cfg, "meta"))]
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = adamw(1e-3)[0](params)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    got = fn(params, opt, batch)
    want = make_train_step(cfg, use_remat=False)(params, opt, batch)
    assert math.isfinite(float(got[2]["loss"]))
    _same(got, want)


def _grow(cache, cfg, batch, max_len, extra_shapes):
    """``cache`` (a prefill's, of the prompt's length) copied into a zero
    cache of ``max_len`` slots, as ``prefill`` merges its own."""
    full = init_cache(cfg, batch, max_len, extra_shapes, device="cpu")

    def one(dst, src):
        if not isinstance(dst, torch.Tensor) or dst.shape == src.shape:
            return src
        dst[..., :src.shape[-2], :] = src
        return dst

    out = {k: v for k, v in cache.items() if k == "pos"}
    for key in full:
        if key != "pos":
            out[key] = tree_map(one, full[key], cache[key])
    return out


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-1.2b", "seamless-m4t-medium"])
def test_host_mesh_prefill_and_serve_steps_equal_launch_serve(arch):
    """``make_step``'s prefill step (a prompt of S tokens) and serve step (a
    cache of S + T slots) on a one-device CPU mesh, driven greedily, give
    ``launch.serve.serve``'s token ids, and their logits and caches are the
    one-card ``prefill``/``decode_step``'s bit for bit."""
    from repro_torch.models import decode_step, prefill

    cfg = get_config(arch).reduced()
    b, s, t = 2, 16, 4
    mesh = make_host_mesh("cpu")
    prefill_fn, _ = make_step(cfg, mesh, InputShape("p", s, b, "prefill"))
    serve_fn, _ = make_step(cfg, mesh, InputShape("d", s + t, b, "decode"))
    params = init_params(torch.Generator(device="cpu").manual_seed(0), cfg, device="cpu")
    prompts, extra = serve_inputs(cfg, b, s, 0, device="cpu")
    extra_shapes = {"vision_len": cfg.num_vision_tokens} if "vision" in extra else \
        {"memory_len": extra["frames"].shape[1]} if "frames" in extra else {}
    logits, cache = prefill_fn(params, {"tokens": prompts, **extra})
    with torch.no_grad():
        want_logits, want_cache = prefill(params, cfg, prompts, s + t, extra)
    assert torch.equal(logits, want_logits)
    cache = _grow(cache, cfg, b, s + t, extra_shapes)
    _same(cache, want_cache)
    tok, ids = logits.argmax(-1), [logits.argmax(-1)]
    for _ in range(t):
        logits, cache = serve_fn(params, tok, cache)
        with torch.no_grad():
            want_logits, want_cache = decode_step(params, cfg, tok, want_cache)
        assert torch.equal(logits, want_logits)
        tok = logits.argmax(-1)
        ids.append(tok)
    _same(cache, want_cache)
    served = serve(cfg, b, s, t, seed=0, device="cpu")
    assert torch.equal(torch.stack(ids, 1), served["token_ids"])


def _reduced_overrides(arch):
    """The reduced configuration's fields as ``run_one``'s overrides, its
    padding left to the mesh."""
    full, red = get_config(arch), get_config(arch).reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(full)
            if f.name not in _PAD and getattr(red, f.name) != getattr(full, f.name)}


_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "hlo_gflops", "hlo_gbytes",
                "coll_gbytes_per_chip", "coll_detail", "t_compute", "t_memory",
                "t_collective", "bottleneck", "model_gflops", "useful_ratio",
                "bytes_per_device", "note", "status", "t_trace_s", "t_extrapolate_s"}


@pytest.mark.parametrize("arch, shape_name", [
    ("mamba2-370m", "decode_32k"), ("zamba2-1.2b", "long_500k"), ("olmo-1b", "decode_32k"),
    ("mixtral-8x22b", "decode_32k"), ("llama-3.2-vision-90b", "decode_32k"),
    ("seamless-m4t-medium", "decode_32k")])
def test_run_one_writes_a_well_formed_record(arch, shape_name, monkeypatch, tmp_path):
    """A reduced configuration of each group through ``run_one`` on the 16x16
    production mesh: a record of the reference's fields with the H100's
    terms, the fake group ended after it.  ``save=False`` writes nothing."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    rec = dryrun.run_one(arch, shape_name, "single", save=False,
                         cfg_overrides=_reduced_overrides(arch))
    assert not dist.is_initialized() and not any(tmp_path.iterdir())
    assert set(rec) == _RECORD_KEYS and rec["status"] == "ok"
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        (get_config(arch).name, shape_name, "single", 256)
    assert rec["note"] == "mode=serve"
    assert set(rec["coll_detail"]["bytes"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                                "all-to-all", "collective-permute"}
    assert rec["hlo_gflops"] > 0 and rec["model_gflops"] > 0 and rec["useful_ratio"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    assert rec["bottleneck"] == max(terms, key=terms.get)
    assert rec["t_compute"] == pytest.approx(rec["hlo_gflops"] * 1e9 / (256 * 989.4e12))
    mem = rec["bytes_per_device"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes"}
    assert 0 < mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]


def test_run_one_skip_record_and_save(monkeypatch, tmp_path):
    """A full-attention configuration at long_500k is skipped by
    ``supports_shape``, as the reference's; a saved record goes to the
    port's own directory under the reference's file name."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    rec = dryrun.run_one("granite-3-2b", "long_500k", "single")
    assert rec == {"arch": "granite-3-2b", "shape": "long_500k", "mesh": "single",
                   "status": "skip", "reason": "granite-3-2b: pure full attention — long_500k "
                   "skipped per DESIGN.md (no sub-quadratic variant in the baseline)"}
    assert [p.name for p in tmp_path.iterdir()] == ["granite-3-2b__long_500k__single.json"]
    assert not dist.is_initialized()


def test_meshes_and_their_groups():
    """The production meshes' shapes and names over fake groups of 256 and
    512 ranks, ended by the context or explicitly; the host mesh is one
    device."""
    with production_mesh() as mesh:
        assert (mesh.axis_names, mesh.shape, mesh.size) == (
            ("data", "model"), {"data": 16, "model": 16}, 256)
        assert dist.get_world_size() == 256 and tuple(mesh.device_mesh.shape) == (16, 16)
    assert not dist.is_initialized()
    mesh = make_production_mesh(multi_pod=True)
    assert (mesh.axis_names, mesh.size, dist.get_world_size()) == (
        ("pod", "data", "model"), 512, 512)
    assert make_production_mesh(layout="32x8").shape == {"data": 32, "model": 8}
    assert dist.get_world_size() == 256
    release_production_mesh()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="not a 256-card mesh"):
        make_production_mesh(layout="16x8")
    host = make_host_mesh("cpu")
    assert (host.size, host.device_mesh, host.device) == (1, None, torch.device("cpu"))


def test_dense_init_on_meta_draws_nothing():
    """On meta: an empty tensor of the shape and dtype, the generator's state
    untouched; elsewhere the same draws as before."""
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    w = dense_init(gen, (64, 32), torch.bfloat16, device="meta")
    assert (w.device.type, tuple(w.shape), w.dtype) == ("meta", (64, 32), torch.bfloat16)
    assert torch.equal(gen.get_state(), state)
    got = dense_init(gen, (64, 32), torch.float32, device="cpu")
    want = torch.randn((64, 32), generator=torch.Generator().manual_seed(3)) * 64 ** -0.5
    assert torch.equal(got, want)
    after = gen.get_state()
    for arch in ("zamba2-1.2b", "mixtral-8x22b"):      # full width: nothing drawn
        params = init_params(gen, get_config(arch), device="meta")
        assert all(t.device.type == "meta" for _, t in flatten_paths(params))
    assert torch.equal(gen.get_state(), after)


def test_dtensor_reaching_a_kernel_wrapper_raises():
    """The dispatch takes the plain version for a meta DTensor; a wrapper
    of a kernel refuses a DTensor outright, launching nothing."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gqa_decode import gqa_decode_cuda

    with fake_mesh((2, 2), ("data", "model")) as mesh:
        local = torch.empty(1, 2, 8, 64, device="meta")
        q = DTensor.from_local(local, mesh.device_mesh, (Shard(0), Replicate()),
                               run_check=False, shape=(2, 2, 8, 64), stride=local.stride())
        before = dict(_build.LAUNCHES)
        with implicit_replication():      # the tensors the plain version makes
            out = ops.flash_attention(q, q, q)
        assert isinstance(out, DTensor) and tuple(out.shape) == (2, 2, 8, 64)
        with pytest.raises(TypeError, match="DTensor"):
            flash_attention_cuda(q, q, q)
        with pytest.raises(TypeError, match="DTensor"):
            gqa_decode_cuda(q[:, :, 0], q, q)
        assert _build.LAUNCHES == before

"""The port's sharding policy, abstract trees, input specs and roofline
formulas against the reference's, at full width (``repro_torch.dist.sharding``,
``repro_torch.launch.{specs,steps,roofline}``).

The reference's shardings are taken over ``jax.sharding.AbstractMesh``
(no devices), the port's over a named mesh with no process group
(``launch.mesh.Mesh``): both are pure functions of the shapes.  The
reference's trees are ``jax.eval_shape`` trees of ``ShapeDtypeStruct``s,
the port's meta tensors; the decode cache's ``pos`` is the port's Python
int where the reference has an int32 scalar."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as ref_get_config
from repro.dist import sharding as RS
from repro.launch import roofline as RR
from repro.launch import specs as RSpecs
from repro.launch import steps as RSteps
from repro.models.config import INPUT_SHAPES as REF_SHAPES
from repro_torch.configs import CLI_ALIASES, get_config
from repro_torch.dist import sharding as S
from repro_torch.dist.sharding import P
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as TSpecs
from repro_torch.launch import steps as TSteps
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS_BF16, Mesh
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.params import flatten_paths, tree_map

ARCHS = sorted(CLI_ALIASES)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "32x8": ((32, 8), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_DTYPES = {jnp.dtype("bfloat16"): torch.bfloat16, jnp.dtype("float32"): torch.float32,
           jnp.dtype("int32"): torch.int32}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _port_mesh(name):
    shape, axes = MESHES[name]
    return Mesh(axes, dict(zip(axes, shape)))


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


@pytest.fixture(autouse=True)
def ref_hints_disarmed():
    """The reference's hint context is module state that another test of
    the worker may have armed: its batch axes must be the default here."""
    RS.enable_sharding_hints(None)
    yield
    RS.enable_sharding_hints(None)


class _Box:
    def __init__(self, spec):
        self.spec = spec


def _port_specs(tree, specs) -> dict:
    """``{path: spec tuple}`` of a spec tree, walked by its tensor tree (a
    spec is itself a tuple)."""
    boxed = tree_map(lambda leaf, spec: _Box(spec), tree, specs)
    return {path: tuple(box.spec) for path, box in flatten_paths(boxed)}


def _ref_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def _ref_leaves(tree) -> dict:
    return {_ref_path(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.NamedSharding))[0]}


def _norm(spec) -> tuple:
    """A spec as a plain tuple without trailing Nones (JAX may drop them)."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------------------
# resolve_spec
# ---------------------------------------------------------------------------

def test_resolve_spec_drops_nondivisible():
    """The reference's own cases (tests/test_sharding_roofline.py)."""
    mesh = FakeMesh({"data": 16, "model": 16})
    assert S.resolve_spec(mesh, (64, 32), P("data", "model")) == P("data", "model")
    assert S.resolve_spec(mesh, (56, 32), P("data", "model")) == P(None, "model")
    assert S.resolve_spec(mesh, (4, 64, 32), P("data", "model")) == P(None, "data", "model")
    mesh2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert S.resolve_spec(mesh2, (64,), P(("pod", "data"))) == P(("pod", "data"))
    assert S.resolve_spec(mesh2, (48,), P(("pod", "data"))) == P(None)


_SPECS = [(), ("data",), ("model",), (None, "model"), ("data", "model"), ("model", "data"),
          (("pod", "data"), None, "model"), (None, None, ("data", "model")),
          ("pod", "data", None, "model"), ("dp_absent", "model")]
_SHAPES = [(), (8,), (48,), (64,), (56, 32), (64, 256), (4, 64, 32), (2, 96, 16, 64),
           (1, 1, 1, 1, 16)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_resolve_spec_sweep_equals_reference(mesh_name):
    shape_, axes = MESHES[mesh_name]
    mesh = FakeMesh(dict(zip(axes, shape_)))
    for spec, shape in itertools.product(_SPECS, _SHAPES):
        want = RS.resolve_spec(mesh, shape, JP(*spec))
        got = S.resolve_spec(mesh, shape, P(*spec))
        assert tuple(got) == tuple(want), (mesh_name, spec, shape)


def test_spec_placements_shard_every_named_axis():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _port_mesh("2x16x16")
    assert S.spec_placements(mesh, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert S.spec_placements(mesh, P(None, "data")) == (Replicate(), Shard(1), Replicate())
    assert S.spec_placements(mesh, P()) == (Replicate(),) * 3


def test_hints_leave_plain_tensors_unchanged():
    """Armed or not, a hint returns a plain tensor as it was: the one-card
    and CPU paths never see the mesh."""
    x = torch.ones(4, 8, 16)
    with S.sharding_hints(_port_mesh("16x16")):
        assert S.shard_hint(x, "act") is x and S.shard_hint(x, "logits") is x
        assert S.shard_spec(x, "dp", None, "model") is x
        assert S.model_axis_size() == 16
    assert S.shard_hint(x, "act") is x and S.model_axis_size() == 1
    with pytest.raises(ValueError, match="unknown hint kind"), \
            S.sharding_hints(_port_mesh("16x16")):
        S.shard_hint(x, "bogus")


# ---------------------------------------------------------------------------
# entry shardings, abstract trees, input specs: every config at full width
# ---------------------------------------------------------------------------

def _padded(arch, model_axis=16):
    return get_config(arch).with_padding(model_axis), ref_get_config(arch).with_padding(
        model_axis)


@pytest.fixture(scope="module")
def abstract_trees():
    """Per arch: (port params, reference params) at full width, padded for
    a 16-way model axis."""
    out = {}
    for arch in ARCHS:
        cfg, rcfg = _padded(arch)
        out[arch] = (TSteps.abstract_params(cfg), RSteps.abstract_params(rcfg))
    return out


def _assert_same_tree(got_tree, want_tree, what):
    got = {p: leaf for p, leaf in flatten_paths(got_tree)}
    want = {_ref_path(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(want_tree)[0]}
    for path in [p for p in want if p.split("/")[-1] == "pos"]:
        # the port's Python int stands for the reference's int32 scalar
        assert isinstance(got.pop(path), int), (what, path)
        ref_pos = want.pop(path)
        assert ref_pos.shape == () and ref_pos.dtype == jnp.int32, (what, path)
    assert got.keys() == want.keys(), what
    for path, leaf in got.items():
        assert leaf.device.type == "meta", (what, path)
        assert tuple(leaf.shape) == tuple(want[path].shape), (what, path)
        assert leaf.dtype == _DTYPES[jnp.dtype(want[path].dtype)], (what, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_reference(arch, abstract_trees):
    got, want = abstract_trees[arch]
    _assert_same_tree(got, want, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_sharding_equals_reference(arch, abstract_trees):
    """Train and serve layouts of every leaf, by key path, on the 16x16 and
    32x8 meshes."""
    params, ref_params = abstract_trees[arch]
    for mesh_name, mode in itertools.product(("16x16", "32x8"), ("train", "serve")):
        got = _port_specs(params, S.param_sharding(_port_mesh(mesh_name), params, mode))
        want = {p: ns.spec for p, ns in _ref_leaves(
            RS.param_sharding(_ref_mesh(mesh_name), ref_params, mode)).items()}
        assert got.keys() == want.keys()
        for path in got:
            assert _norm(got[path]) == _norm(want[path]), (mesh_name, mode, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_their_shardings_equal_reference(arch):
    """``input_specs`` (the decode cache too) and ``supports_shape`` for
    every shape; ``batch_sharding`` and ``cache_sharding`` of them, also
    with the weight-stationary batch axes."""
    cfg, rcfg = _padded(arch)
    mesh, rmesh = _port_mesh("16x16"), _ref_mesh("16x16")
    for name in INPUT_SHAPES:
        shape, rshape = INPUT_SHAPES[name], REF_SHAPES[name]
        assert TSpecs.supports_shape(cfg, shape) == RSpecs.supports_shape(rcfg, rshape)
        got, want = TSpecs.input_specs(cfg, shape), RSpecs.input_specs(rcfg, rshape)
        _assert_same_tree(got, want, (arch, name))
        for batch_axes in (None, ("model",)):
            RS.enable_sharding_hints(None, batch_axes=batch_axes)
            with S.sharding_hints(None, batch_axes):
                for key, fn, rfn in (("batch", S.batch_sharding, RS.batch_sharding),
                                     ("token", S.batch_sharding, RS.batch_sharding),
                                     ("cache", S.cache_sharding, RS.cache_sharding)):
                    if key not in got:
                        continue
                    mine = _port_specs(got[key], fn(mesh, got[key]))
                    theirs = {p: ns.spec for p, ns in _ref_leaves(
                        rfn(rmesh, want[key])).items()}
                    assert mine.keys() == theirs.keys()
                    for path in mine:
                        assert _norm(mine[path]) == _norm(theirs[path]), (name, key, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_mode_decisions_equal_reference_at_its_hbm(arch, abstract_trees, monkeypatch):
    """``_fits_tp_only`` at the reference's 16 GB, and ``resolve_serve_mode``
    with the port's HBM size set to it, decide as the reference does."""
    params, ref_params = abstract_trees[arch]
    cfg, rcfg = _padded(arch)
    for mesh_name in ("16x16", "32x8"):
        mesh, rmesh = _port_mesh(mesh_name), _ref_mesh(mesh_name)
        want = RS._fits_tp_only(rmesh, ref_params)
        assert S._fits_tp_only(mesh, params, hbm_bytes=16e9) == want
        monkeypatch.setattr(S, "HBM_BYTES_PER_CHIP", 16e9)
        for mode in ("serve", "serve_tp", "serve_auto", "serve_ws", "train"):
            assert TSteps.resolve_serve_mode(cfg, mesh, mode) == \
                RSteps.resolve_serve_mode(rcfg, rmesh, mode)
        monkeypatch.undo()


def test_serve_auto_decisions_on_the_h100(abstract_trees):
    """At 80 GB a card holds every configuration's TP-only weights on the
    16x16 and 32x8 meshes (0.6 of 80 GB against the weights over the model
    axis: mixtral-8x22b's 282 GB over 8 is 35 GB), where the reference's
    16 GB v5e holds neither mixtral-8x22b's nor llama-3.2-vision-90b's (nor,
    over 8, phi3.5-moe's)."""
    assert S.HBM_BYTES_PER_CHIP == HBM_BYTES == 80e9
    v5e_refuses = {"16x16": {"mixtral-8x22b", "llama-3.2-vision-90b"},
                   "32x8": {"mixtral-8x22b", "llama-3.2-vision-90b", "phi3.5-moe-42b-a6.6b"}}
    for mesh_name in ("16x16", "32x8"):
        mesh, rmesh = _port_mesh(mesh_name), _ref_mesh(mesh_name)
        got = {arch: TSteps.resolve_serve_mode(_padded(arch)[0], mesh, "serve_auto")
               for arch in ARCHS}
        assert got == {arch: "serve_tp" for arch in ARCHS}
        v5e = {arch for arch in ARCHS if not RS._fits_tp_only(rmesh, abstract_trees[arch][1])}
        assert v5e == v5e_refuses[mesh_name]


# ---------------------------------------------------------------------------
# roofline formulas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert R.active_param_count(cfg) == RR.active_param_count(rcfg)
    for name in INPUT_SHAPES:
        assert R.model_flops(cfg, INPUT_SHAPES[name]) == RR.model_flops(rcfg, REF_SHAPES[name])


def test_h100_constants():
    assert (PEAK_FLOPS_BF16, HBM_BW, HBM_BYTES, LINK_BW) == (989.4e12, 3.35e12, 80e9, 50e9)


def test_analyze_terms_and_collective_weights():
    """The three terms over the H100's constants: FLOPs and bytes global,
    split over the cards; collectives per card, all-reduce counted twice."""
    cfg, shape = get_config("olmo-1b"), INPUT_SHAPES["train_4k"]
    coll = R.collective_bytes([("all-gather", 100), ("all-reduce", 10), ("all-reduce", 30),
                               ("all-to-all", 7), ("reduce-scatter", 5)])
    assert coll["bytes"] == {"all-gather": 100, "all-reduce": 40, "reduce-scatter": 5,
                             "all-to-all": 7, "collective-permute": 0}
    assert coll["counts"]["all-reduce"] == 2 and coll["counts"]["collective-permute"] == 0
    rec = R.analyze(cfg, shape, "single", 256, {"flops": 256 * 989.4e12, "bytes": 512 * 3.35e12,
                                                 "coll": coll}, note="n")
    assert rec.t_compute == pytest.approx(1.0) and rec.t_memory == pytest.approx(2.0)
    assert rec.t_collective == pytest.approx((100 + 80 + 5 + 7) / 50e9)
    assert rec.bottleneck == "memory" and rec.chips == 256
    assert rec.model_gflops == pytest.approx(R.model_flops(cfg, shape) / 1e9)
    assert rec.useful_ratio == pytest.approx(R.model_flops(cfg, shape) / (256 * 989.4e12))
    assert np.isclose(rec.hlo_gflops, 256 * 989.4e12 / 1e9)

"""The zoo's training on the CPU: the port's ``forward_train`` and its
gradient against ``jax.value_and_grad`` of the reference's, the loss alone,
``use_remat``, and one ``launch.steps.make_train_step`` step against the
reference's ``make_train_step`` on its host mesh.

Parameters are the reference's ``init_params``, crossing through
``np.asarray`` and ``repro_torch.params.from_numpy``; batches are drawn
with numpy.  f32, TF32 off, both packages on their XLA / plain paths (the
port's CPU path takes the ``autograd.Function``s of ``flash_attention`` and
``ssd_scan``, whose backward is the closed form of ``kernels.ref``).
Tolerances: the loss 1e-5 relative, each gradient leaf 1e-4 of its scale.

The six groups' reduced configs, except the hybrid's depth: zamba2-1.2b's
``reduced()`` stacks 12 Mamba2 blocks, over which the f32 gradients of
both packages drift 5e-5 to 1e-4 of their scale from an f64 evaluation
(the same holds for mamba2-370m cut to 12 blocks), so that they differ by
1.2e-4 to 3.6e-4 of the scale; its case keeps the hybrid program (two
superblocks, the shared attention applied twice) with two Mamba2 blocks a
superblock (``attn_every=2``), where they agree within ~3e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import common as RC
from repro.models import transformer as RT
from repro.models.config import InputShape
from repro.train.optim import adamw as ref_adamw
from repro_torch import params as P
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import forward_train
from repro_torch.train.optim import adamw

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4     # of each leaf's scale


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(arch, **changes):
    cfg = ref_get_config(arch).reduced()
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, num_layers=4, attn_every=2)
    return dataclasses.replace(cfg, **changes)


def _port_cfg(ref_cfg):
    return ArchConfig(**dataclasses.asdict(ref_cfg))


def _batch(cfg, b=2, s=64, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    if masked:
        batch["labels"][0, :20] = -1
        batch["labels"][1, 50:] = -1
    if cfg.arch_type == "vlm":
        batch["vision"] = rng.normal(size=(b, cfg.num_vision_tokens, cfg.d_model)).astype(
            np.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = rng.normal(size=(b, 40, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(tparams, cfg, batch, use_remat=False):
    leaves = [t.detach().requires_grad_() for t in P.tree_leaves(tparams)]
    loss = forward_train(P.tree_unflatten(tparams, leaves), cfg,
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         use_remat=use_remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, leaves)]


def _assert_leaves_close(tparams, grads, want_tree, tol, what="grad"):
    want = dict(P.flatten_paths(jax.tree_util.tree_map(np.asarray, want_tree)))
    paths = [p for p, _ in P.flatten_paths(tparams)]
    assert sorted(paths) == sorted(want)
    for path, g in zip(paths, grads):
        w = np.asarray(want[path], np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.detach().double().numpy() - w).max())
        assert err <= tol * scale, f"{what} {path}: {err:.3e} > {tol} of {scale:.3e}"


CASES = {
    "dense-granite": ("granite-3-2b", {}, False),
    "moe-phi3.5": ("phi3.5-moe-42b-a6.6b", {}, False),
    "ssm-mamba2": ("mamba2-370m", {}, False),
    "hybrid-zamba2": ("zamba2-1.2b", {}, False),
    "vlm-llama-vision": ("llama-3.2-vision-90b", {}, False),
    "audio-seamless": ("seamless-m4t-medium", {}, False),
    "masked-labels": ("granite-3-2b", {}, True),
    "padded-vocab": ("granite-3-2b", {"vocab_size": 1001}, True),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_forward_train_loss_and_gradients_match_reference(case):
    arch, changes, masked = CASES[case]
    ref_cfg = _ref_cfg(arch, **changes)
    cfg = _port_cfg(ref_cfg)
    if case == "padded-vocab":
        assert cfg.physical_vocab == 1008 != cfg.vocab_size
    params = RT.init_params(jax.random.PRNGKey(0), ref_cfg)
    tparams = P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    batch = _batch(cfg, masked=masked)
    want_loss, want = jax.value_and_grad(lambda p: RT.forward_train(
        p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()}, use_remat=False))(params)
    loss, grads = _port_grads(tparams, cfg, batch)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    _assert_leaves_close(tparams, grads, want, LEAF_TOL)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "phi3.5-moe-42b-a6.6b", "seamless-m4t-medium"])
def test_remat_changes_no_bit(arch):
    """``use_remat`` recomputes each layer (the encoder's too) in the
    backward; the loss and every gradient keep their bits."""
    cfg = _port_cfg(_ref_cfg(arch))
    params = RT.init_params(jax.random.PRNGKey(1), _ref_cfg(arch))
    tparams = P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    batch = _batch(cfg, seed=1, masked=True)
    loss0, g0 = _port_grads(tparams, cfg, batch, use_remat=False)
    loss1, g1 = _port_grads(tparams, cfg, batch, use_remat=True)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


GROUPS = {case: arch for case, (arch, changes, masked) in CASES.items()
          if not changes and not masked}
#: the groups whose stacked leaves carry two layer axes [n_super, k, ...]
NESTED = {"zamba_super": "mamba", "vlm_super": "self"}


def _select_layers(stacked):
    """The forward's layers as ``t[i]`` views of each stacked leaf."""
    return [P.tree_map(lambda t: t[i], stacked)
            for i in range(P.tree_leaves(stacked)[0].shape[0])]


@pytest.mark.parametrize("use_remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("case", list(GROUPS), ids=list(GROUPS))
def test_unbound_layers_give_the_bits_of_select_views(case, use_remat, monkeypatch):
    """Unbinding each stacked leaf once changes how the backward gathers a
    leaf's gradient (one ``stack`` in place of L zero-filled copies summed),
    not one bit of the loss or of any gradient."""
    ref_cfg = _ref_cfg(GROUPS[case])
    cfg = _port_cfg(ref_cfg)
    params = RT.init_params(jax.random.PRNGKey(5), ref_cfg)
    tparams = P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    batch = _batch(cfg, seed=5, masked=True)
    loss, grads = _port_grads(tparams, cfg, batch, use_remat=use_remat)
    monkeypatch.setattr(T, "_layers", _select_layers)
    want_loss, want = _port_grads(tparams, cfg, batch, use_remat=use_remat)
    assert torch.equal(loss, want_loss)
    for (path, _), g, w in zip(P.flatten_paths(tparams), grads, want):
        assert torch.equal(g, w), path


def _graph_nodes(root):
    seen, todo = {}, [root]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        todo.extend(nxt for nxt, _ in node.next_functions)
    return list(seen.values())


@pytest.mark.parametrize("case", list(GROUPS), ids=list(GROUPS))
def test_stacked_leaves_are_unbound_once_and_never_selected(case):
    """In ``forward_train``'s graph each stacked leaf feeds one
    ``UnbindBackward0``, and in a nested group each of those feeds one more
    per outer slice.  No ``SelectBackward0`` reads a stacked leaf, nor a
    nested group's outer slice (still a stack of k layers), which would
    bring back the L (or k) zero-filled gradients a leaf and their sum; a
    layer's own parameter may be indexed (Mamba2's ``conv_w[i]``)."""
    ref_cfg = _ref_cfg(GROUPS[case])
    cfg = _port_cfg(ref_cfg)
    params = RT.init_params(jax.random.PRNGKey(6), ref_cfg)
    tparams = P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    batch = _batch(cfg, seed=6)
    leaves = [t.detach().requires_grad_() for t in P.tree_leaves(tparams)]
    tree = P.tree_unflatten(tparams, leaves)
    loss = forward_train(tree, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                         use_remat=False)
    stacked = {id(t): path for path, t in P.flatten_paths(tree["groups"])}
    nested = {id(t): t.shape[0] for g, sub in NESTED.items() if g in tree["groups"]
              for t in P.tree_leaves(tree["groups"][g][sub])}
    assert stacked and set(nested) <= set(stacked)

    def reads(node):
        """The stacked leaf a node reads directly, else None."""
        nxt = node.next_functions[0][0] if node.next_functions else None
        return stacked.get(id(getattr(nxt, "variable", None)))

    nodes = _graph_nodes(loss.grad_fn)
    outer = [n for n in nodes if n.name() == "UnbindBackward0" and reads(n) is not None]
    outer_ids = {id(n) for n in outer}
    inner = [n for n in nodes if n.name() == "UnbindBackward0"
             and id(n.next_functions[0][0]) in outer_ids]
    by_leaf = {}
    for n in outer:
        by_leaf.setdefault(reads(n), []).append(n)
    assert sorted(by_leaf) == sorted(stacked.values())
    assert all(len(ns) == 1 for ns in by_leaf.values())
    stacks = {id(n) for n in outer if id(n.next_functions[0][0].variable) in nested}
    for t in leaves:
        if id(t) in nested:
            (n,) = by_leaf[stacked[id(t)]]
            assert sum(m.next_functions[0][0] is n for m in inner) == nested[id(t)]
    assert len(outer) + len(inner) == len(stacked) + sum(nested.values())
    for n in nodes:
        if n.name() == "SelectBackward0":
            src = n.next_functions[0][0]
            assert reads(n) is None and id(src) not in stacks, n


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_softmax_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.uniform(size=(3, 7)) > 0.4).astype(np.float32) if masked else None
    want = RC.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None else jnp.asarray(mask))
    got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an all-masked batch divides by max(0, 1)
    zero = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.zeros(3, 7))
    assert float(zero) == 0.0


def test_moe_gradient_reaches_the_router_and_every_expert_with_tokens():
    cfg = _port_cfg(_ref_cfg("phi3.5-moe-42b-a6.6b"))
    params = RT.init_params(jax.random.PRNGKey(2), _ref_cfg("phi3.5-moe-42b-a6.6b"))
    layer = P.from_numpy(jax.tree_util.tree_map(
        lambda t: np.asarray(t[0]), params["groups"]["decoder"]["moe"]), "cpu")
    leaves = {k: v.detach().requires_grad_() for k, v in layer.items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(40, cfg.d_model)).astype(
        np.float32))
    y, aux = TM.moe_apply(leaves, cfg, x)
    (y.square().sum() + aux).backward()
    _, _, expert_idx = TM.moe_route(layer, x, cfg.experts_per_token)
    used = torch.unique(expert_idx)
    assert leaves["router"].grad.abs().sum() > 0
    for name in ("w_gate", "w_up", "w_down"):
        g = leaves[name].grad
        for e in range(cfg.num_experts):
            assert bool(g[e].abs().sum() > 0) == bool((used == e).any()), (name, e)


def test_train_step_matches_reference_step():
    """One step from the same parameters and zero moments: the loss, the
    gradient norm, the learning rate, and every new parameter and moment
    (the reference's ``make_train_step`` jitted on its 1x1 host mesh)."""
    ref_cfg = _ref_cfg("zamba2-1.2b")
    cfg = _port_cfg(ref_cfg)
    params = RT.init_params(jax.random.PRNGKey(3), ref_cfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    batch = _batch(cfg, seed=3, masked=True)
    mesh = make_host_mesh()
    fn, _ = ref_make_train_step(ref_cfg, mesh, InputShape("t", 64, 2, "train"),
                                use_remat=False)
    init_fn, _ = ref_adamw(3e-4)
    with mesh:
        want_p, want_o, want_aux = fn(jax.tree_util.tree_map(jnp.asarray, host),
                                      init_fn(params),
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = P.from_numpy(host, "cpu")
    opt = adamw(3e-4)[0](tparams)
    step = make_train_step(cfg, use_remat=False)
    new_p, new_o, aux = step(tparams, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(aux["loss"]) - float(want_aux["loss"])) <= LOSS_RTOL * float(
        want_aux["loss"])
    # the norm over every leaf, each within LEAF_TOL of its scale
    np.testing.assert_allclose(float(aux["grad_norm"]), float(want_aux["grad_norm"]),
                               rtol=LEAF_TOL)
    np.testing.assert_allclose(float(aux["lr"]), float(want_aux["lr"]), rtol=1e-7)
    assert int(new_o.step) == int(want_o.step) == 1
    _assert_leaves_close(tparams, P.tree_leaves(new_o.mu), want_o.mu, LEAF_TOL, "mu")
    _assert_leaves_close(tparams, P.tree_leaves(new_o.nu), want_o.nu, 2 * LEAF_TOL, "nu")
    # AdamW's first step moves a weight by lr * g / (|g| + eps) ~ lr (6e-7):
    # the updates agree within 1e-3 lr but for the weights whose |g| is near
    # eps = 1e-8, where the ratio turns on the gradient's last bits (~5e-4 of
    # the elements), and within 0.5 lr everywhere
    lr = float(aux["lr"])
    wp = dict(P.flatten_paths(jax.tree_util.tree_map(np.asarray, want_p)))
    for (path, p0), p1 in zip(P.flatten_paths(tparams), P.tree_leaves(new_p)):
        d = np.abs((p1.double() - p0.double()).numpy() - (wp[path] - p0.double().numpy()))
        assert d.max() <= 0.5 * lr and (d > 1e-3 * lr).mean() <= 1e-3, path
    assert all(torch.equal(a, b) for a, b in zip(P.tree_leaves(tparams),
                                                  P.tree_leaves(P.from_numpy(host, "cpu"))))

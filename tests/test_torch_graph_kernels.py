"""Stage 1's graph aggregation in the port against the reference, on the same
numpy inputs: the per-edge-type mean that GCN runs in one launch on the card
(``kernels.ref.csr_spmm_etype_mean_ref``, its plain version, and
``core.layers.per_etype_mean`` over it) against the reference's
``per_etype_mean`` with its jnp path and with its Pallas kernel in interpret
mode, and the port's GCN, GAT and SAGE layers against the reference's on a
community graph.  Tolerances are the reference tests': 2e-5 in f32 and 2e-2
in bf16; the summation order differs between the frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.layers as RL
from repro.core.graph import PaddedGraph as RefGraph
from repro_torch.core import layers as L
from repro_torch.core.graph import EdgeType, PaddedGraph
from repro_torch.kernels import ops, ref
from repro_torch.params import from_numpy

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _graph(n: int, d: int, seed: int) -> RefGraph:
    """A padded graph with every case the kernel branches on: valid slots
    that point at rows 0 and N-1, empty slots laid out as ``pad_graph`` lays
    them (row 0, type 0, mask 0) and with stray indices and types, a row with
    every slot masked, non-binary mask values, and no slot of type 3."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, d)).astype(np.int32)
    etype = rng.integers(0, 3, (n, d)).astype(np.int32)
    mask = (rng.uniform(size=(n, d)) < 0.5).astype(np.float32)
    mask[rng.uniform(size=(n, d)) < 0.1] = 0.5
    pad = (mask == 0) & (np.arange(n)[:, None] % 2 == 0)
    idx[pad], etype[pad] = 0, 0
    idx[0, 0], idx[1, -1] = 0, n - 1
    mask[0, 0] = mask[1, -1] = 1.0
    mask[2] = 0.0
    zeros_n = np.zeros(n, np.int32)
    return RefGraph(np.zeros((n, 1), np.float32), idx, mask, etype, zeros_n, zeros_n,
                    np.zeros(n, np.float32), np.zeros(n, np.float32))


def _port(graph: RefGraph) -> PaddedGraph:
    return PaddedGraph(*graph).to("cpu")


@pytest.mark.parametrize("d", [1, 24, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_etype_mean_matches_reference_per_etype_mean(d, dtype, use_pallas):
    n, hdim = 70, 48
    graph = _graph(n, d, seed=d)
    x = np.random.default_rng(d + 100).normal(size=(n, hdim)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(RL.per_etype_mean(jnp.asarray(x, jdt), graph, use_pallas), np.float32)
    g = _port(graph)
    h = torch.from_numpy(x).to(tdt)
    got = ref.csr_spmm_etype_mean_ref(h, g.nbr_idx, g.nbr_mask, g.nbr_etype, EdgeType.NUM)
    assert got.dtype == tdt and tuple(got.shape) == (EdgeType.NUM, n, hdim)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    # the layer's entry goes through ops, which takes the plain version here
    torch.testing.assert_close(L.per_etype_mean(h, g), got, rtol=0, atol=0)
    # every slot of row 2 is masked, and no slot has type 3: both give zeros
    assert not got[:, 2].any() and not got[3].any()


def test_etype_mean_is_the_single_call_per_type():
    """Each type's plane is ``csr_spmm`` with that type's mean weights, and
    a type outside [0, num_types) lands in no plane."""
    graph = _graph(40, 9, seed=5)
    g = _port(graph)
    etype = g.nbr_etype.clone()
    etype[::4, 0] = 7                               # a type past the vocabulary
    h = torch.from_numpy(np.random.default_rng(6).normal(size=(40, 20)).astype(np.float32))
    got = ops.csr_spmm_etype_mean(h, g.nbr_idx, g.nbr_mask, etype, 3)
    assert tuple(got.shape) == (3, 40, 20)
    for e in range(3):
        w = g.nbr_mask * (etype == e)
        want = ops.csr_spmm(h, g.nbr_idx, w / w.sum(-1, keepdim=True).clamp_min(1.0))
        torch.testing.assert_close(got[e], want, rtol=0, atol=0)


def _layer_inputs(graph, in_dim: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(graph.nbr_idx.shape[0], in_dim)).astype(np.float32)
    return x, torch.from_numpy(x)


@pytest.mark.parametrize("gnn_type", ["gcn", "gat", "sage"])
@pytest.mark.parametrize("edges", ["stage1", "all"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_layers_match_reference_on_a_community(small_communities, gnn_type, edges, use_pallas):
    """One GNN layer of the port against the reference's, with the same
    parameters, on a community graph: with the final-hop edges masked as
    stage 1 masks them, and with all four edge types."""
    graph = small_communities[0].graph
    if edges == "stage1":
        graph = graph._replace(
            nbr_mask=graph.nbr_mask * (graph.nbr_etype != EdgeType.ENTITY_TO_ORDER))
    in_dim, out_dim = 24, 16
    init, apply = {"gcn": (RL.gcn_init, RL.gcn_apply), "gat": (RL.gat_init, RL.gat_apply),
                   "sage": (RL.sage_init, RL.sage_apply)}[gnn_type]
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3), in_dim, out_dim))
    if gnn_type == "gat":   # a non-zero edge-type bias, so the bias path counts
        params["a_et"] = np.random.default_rng(4).normal(size=EdgeType.NUM).astype(np.float32)
    x, h = _layer_inputs(graph, in_dim, seed=9)
    want = np.asarray(apply(params, jnp.asarray(x), graph, use_pallas))
    got = L.LAYER_REGISTRY[gnn_type][1](from_numpy(params, "cpu"), h, _port(graph))
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])

"""Fused online stage-2 scoring on the card (the speed-layer hot path).

    towers   e = relu(e0 @ Wt[t] + bt[t]) per slot type          (typed only)
    tower    h = relu(feats @ W_in + b_in + type_emb[ORDER]),
                 then (L-1) x relu(h @ W_self_l + b_l)
    agg      a = masked mean (gcn/sage) or masked attention (gat)
    combine  g = relu(h @ W_self + a @ W_nbr + b)
    logit    y = MLP([g ; feats])

One launch of the CUDA kernel ``csrc/stage2_score.cu`` per micro-batch, the
port of the TPU kernel ``repro.kernels.stage2_score.stage2_score_pallas``.
:func:`flatten_stage2_params` keeps the Pallas kernel's positional argument
order: it is the ABI of the plain version ``kernels.ref.stage2_score_ref``.
The kernel reads :func:`pack_stage2_params`'s buffer instead, built once per
model: every weight in the order the kernel consumes it, each segment on a
16-byte boundary so that one bulk copy brings it into shared memory.
:func:`stage2_plan` lays out the kernel's shared memory for a pack, from the
widths alone, so that a row's arithmetic never depends on the batch.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from repro_torch.kernels._build import check_launch, check_tensor, load_library, stream_ptr

MAX_WIDTH = 256      # widest hidden and MLP layer the kernel takes
ROWS_PER_BLOCK = 4   # micro-batch rows per block (a warp each), fewer if shared memory is short
RING_DEPTH = 2       # tiles in flight when the weights do not fit at once


def flatten_stage2_params(params, gnn_type: str) -> tuple:
    """Extract the stage-2-relevant leaves of an ``lnn_init`` tree in the
    kernel's positional argument order.

    Stage-1 self-transform layers stack into ``[L-1, H, H]``, biases and
    embedding rows become ``[1, H]``, and the MLP's first weight splits at
    row H into the ``g_out`` block and the raw-feature block.
    """
    from repro_torch.core.graph import EdgeType, NodeType

    h = params["last"]["w_self"].shape[0]
    flat = [
        params["input"]["w"],
        params["input"]["b"][None, :],
        params["type_emb"][NodeType.ORDER][None, :],
        torch.stack([lyr["w_self"] for lyr in params["gnn"]]),
        torch.stack([lyr["b"] for lyr in params["gnn"]]),
    ]
    if "typed" in params:
        flat += [params["typed"]["tower_w"], params["typed"]["tower_b"]]
    p = params["last"]
    if gnn_type == "gcn":
        flat += [p["w_self"], p["w_nbr"][EdgeType.ENTITY_TO_ORDER], p["b"][None, :]]
    elif gnn_type == "sage":
        flat += [p["w_self"], p["w_nbr"], p["b"][None, :]]
    elif gnn_type == "gat":
        flat += [p["w_self"], p["b"][None, :], p["w"],
                 p["a_src"][:, None], p["a_dst"][:, None],
                 p["a_et"][EdgeType.ENTITY_TO_ORDER][None, None]]
    else:
        raise ValueError(f"unknown gnn_type {gnn_type}")
    mlp = params["mlp"]
    w0 = mlp[0]["w"]
    flat += [w0[:h], w0[h:], mlp[0]["b"][None, :]]
    for layer in mlp[1:]:
        flat += [layer["w"], layer["b"][None, :]]
    return tuple(flat)


def unpack_stage2_params(flat, gnn_type: str, typed: bool) -> dict:
    """Name the entries of a :func:`flatten_stage2_params` tuple; the extra
    MLP layers come back as ``"mlp": [(w, b), ...]``."""
    names = ["w_in", "b_in", "type_row", "tower_w", "tower_b"]
    if typed:
        names += ["typed_w", "typed_b"]
    if gnn_type == "gat":
        names += ["w_self", "b_last", "w_gat", "a_src", "a_dst", "a_et"]
    elif gnn_type in ("gcn", "sage"):
        names += ["w_self", "w_nbr", "b_last"]
    else:
        raise ValueError(f"unknown gnn_type {gnn_type}")
    names += ["w0g", "w0f", "b0"]
    rest = len(flat) - len(names)
    if rest < 0 or rest % 2:
        raise ValueError(f"{len(flat)} stage-2 weights do not fit the "
                         f"{gnn_type} layout (typed={typed})")
    p = dict(zip(names, flat))
    extra = flat[len(names):]
    p["mlp"] = [(extra[2 * i], extra[2 * i + 1]) for i in range(rest // 2)]
    return p


# --------------------------------------------------------------- the pack

def _align4(n: int) -> int:
    return -(-n // 4) * 4


def _lanes(n_out: int, many_rows: bool) -> tuple[int, int]:
    """(slices, quads) of a layer with ``n_out`` columns: a warp computes
    one row's layer (or several slot rows at once when ``many_rows``); each
    lane owns ``quads`` column quads (4 columns, one 16-byte load of a weight
    row) per pass, up to 8 lanes share a row of weights, and the other
    ``slices`` lanes of the warp split each dot product between them."""
    n_quads = -(-n_out // 4)
    lanes = 1
    while lanes < 8 and lanes < n_quads:
        lanes *= 2
    per_lane = -(-n_quads // lanes)
    quads = 1 if per_lane <= 1 else 2 if per_lane <= 2 or many_rows else 4
    return 32 // lanes, quads


#: what a layer reads and writes in the kernel (``enum S2Role``, in order)
ROLES = ("typed", "input", "tower", "combine", "head", "mlp")


class Segment(NamedTuple):
    """One layer's weight matrix in the pack: ``rows x cols`` at float
    offset ``off``, rows ``stride`` floats apart; in the kernel each output's
    dot product is shared by ``slices`` lanes and a lane owns ``quads``
    column quads; the layer adds the vectors named in ``bias``, then applies
    relu if ``relu``.  ``role`` is one of ROLES."""
    name: str
    role: str
    off: int
    rows: int
    cols: int
    stride: int
    slices: int
    quads: int
    bias: tuple
    relu: bool


@dataclass(eq=False)
class Stage2Pack:
    """The kernel's weights, packed once per model (:func:`pack_stage2_params`).

    ``buffer`` holds the vector region (biases, embedding rows, GAT's
    score vectors; ``vectors`` maps a name to ``(offset, length)``), then every
    weight matrix in the order the kernel consumes it (``segments``).  All
    offsets are multiples of 4 floats."""
    buffer: torch.Tensor
    gnn_type: str
    typed: bool
    h: int
    f: int
    n_tower: int
    n_types: int
    mlp: tuple            # output width of every MLP layer, w0's first
    vectors: dict
    vec_floats: int
    segments: tuple
    ld: int               # row stride of the kernel's activation buffers
    _args: dict = field(default_factory=dict, repr=False)   # (K, card) -> (struct, table)

    @property
    def gat(self) -> bool:
        return self.gnn_type == "gat"


def pack_stage2_params(flat, gnn_type: str, typed: bool) -> Stage2Pack:
    """Pack a :func:`flatten_stage2_params` tuple into one contiguous f32
    buffer on the weights' device, in the order ``csrc/stage2_score.cu``
    consumes it.  Two products are merged by stacking their weights: the
    last-layer combine ``h @ W_self + agg @ W_nbr`` becomes
    ``[h | agg] @ [W_self; W_nbr]`` (gcn, sage), and the head's first layer
    ``g @ W0g + feats @ W0f`` becomes ``[g | feats] @ W0``.  GAT's
    ``(e @ W) @ a_src`` and ``(h @ W) @ a_dst`` become ``e @ u_src`` and
    ``h @ u_dst`` with ``u = W @ a`` (computed here in f64), and its
    attention sum of ``e @ W`` becomes the attention sum of ``e``, projected
    by ``W`` in the stacked combine ``[h | agg] @ [W_self; W]``.
    :func:`unpack_stage2_pack` gives the tuple back."""
    p = unpack_stage2_params(flat, gnn_type, typed)
    h, f = p["w_self"].shape[0], p["w_in"].shape[0]
    mlp = (p["w0g"].shape[1],) + tuple(w.shape[1] for w, _ in p["mlp"])
    n_tower = p["tower_w"].shape[0]
    n_types = p["typed_w"].shape[0] if typed else 0
    if h > MAX_WIDTH or max(mlp) > MAX_WIDTH:
        raise ValueError(f"stage2_score takes widths up to {MAX_WIDTH}: H={h}, MLP {mlp}")

    vectors = [("b_in", p["b_in"]), ("type_row", p["type_row"])]
    vectors += [(f"tower_b[{i}]", p["tower_b"][i]) for i in range(n_tower)]
    vectors += [(f"typed_b[{i}]", p["typed_b"][i]) for i in range(n_types)]
    vectors += [("b_last", p["b_last"])]
    if gnn_type == "gat":
        w = p["w_gat"].double()
        vectors += [("a_src", p["a_src"]), ("a_dst", p["a_dst"]), ("a_et", p["a_et"]),
                    ("u_src", (w @ p["a_src"].double()).float()),
                    ("u_dst", (w @ p["a_dst"].double()).float())]
    vectors += [("b0", p["b0"])] + [(f"mlp_b[{i + 1}]", b) for i, (_, b) in enumerate(p["mlp"])]

    # (name, role, weight, biases, relu), in the kernel's order
    mats = [(f"typed_w[{i}]", "typed", p["typed_w"][i], (f"typed_b[{i}]",), True)
            for i in range(n_types)]
    mats += [("w_in", "input", p["w_in"], ("b_in", "type_row"), True)]
    mats += [(f"tower_w[{i}]", "tower", p["tower_w"][i], (f"tower_b[{i}]",), True)
             for i in range(n_tower)]
    w_nbr = p["w_gat"] if gnn_type == "gat" else p["w_nbr"]
    mats += [("w_self_nbr", "combine", torch.cat([p["w_self"], w_nbr], 0), ("b_last",), True)]
    n_mlp = len(mlp)
    mats += [("w0", "head", torch.cat([p["w0g"], p["w0f"]], 0), ("b0",), n_mlp > 1)]
    mats += [(f"mlp_w[{i}]", "mlp", w, (f"mlp_b[{i}]",), i < n_mlp - 1)
             for i, (w, _) in enumerate(p["mlp"], 1)]

    off, vec_at = 0, {}
    for name, v in vectors:
        vec_at[name] = (off, v.numel())
        off += _align4(v.numel())
    vec_floats = off
    segments = []
    for name, role, w, bias, relu in mats:
        rows, cols = w.shape
        slices, quads = _lanes(cols, role == "typed")
        segments.append(Segment(name, role, off, rows, cols, _align4(cols), slices, quads, bias,
                                relu))
        off += rows * segments[-1].stride
    buf = torch.zeros(off, dtype=torch.float32, device=p["w_in"].device)
    for name, v in vectors:
        o, n = vec_at[name]
        buf[o:o + n].copy_(v.reshape(-1))
    for seg, (_, _, w, _, _) in zip(segments, mats):
        buf[seg.off:seg.off + seg.rows * seg.stride].view(seg.rows, seg.stride)[:, :seg.cols] \
            .copy_(w)
    ld = _align4(max(2 * h, h + f, *mlp))
    return Stage2Pack(buf, gnn_type, typed, h, f, n_tower, n_types, mlp, vec_at, vec_floats,
                      tuple(segments), ld)


def unpack_stage2_pack(pack: Stage2Pack) -> tuple:
    """The :func:`flatten_stage2_params` tuple a pack was made from."""
    buf, h = pack.buffer, pack.h
    seg = {s.name: s for s in pack.segments}

    def mat(name):
        s = seg[name]
        return buf[s.off:s.off + s.rows * s.stride].view(s.rows, s.stride)[:, :s.cols]

    def vec(name):
        o, n = pack.vectors[name]
        return buf[o:o + n]

    flat = [mat("w_in"), vec("b_in")[None], vec("type_row")[None],
            torch.stack([mat(f"tower_w[{i}]") for i in range(pack.n_tower)]),
            torch.stack([vec(f"tower_b[{i}]") for i in range(pack.n_tower)])]
    if pack.typed:
        flat += [torch.stack([mat(f"typed_w[{i}]") for i in range(pack.n_types)]),
                 torch.stack([vec(f"typed_b[{i}]") for i in range(pack.n_types)])]
    w = mat("w_self_nbr")
    if pack.gat:
        flat += [w[:h], vec("b_last")[None], w[h:], vec("a_src")[:, None],
                 vec("a_dst")[:, None], vec("a_et")[None]]
    else:
        flat += [w[:h], w[h:], vec("b_last")[None]]
    w0 = mat("w0")
    flat += [w0[:h], w0[h:], vec("b0")[None]]
    for i in range(1, len(pack.mlp)):
        flat += [mat(f"mlp_w[{i}]"), vec(f"mlp_b[{i}]")[None]]
    return tuple(t.contiguous() for t in flat)


# ----------------------------------------------------- shared-memory plan

@dataclass(frozen=True)
class Stage2Plan:
    """The kernel's shared memory for one pack and slot count K.

    ``rows``: micro-batch rows per block, one warp each.  ``whole``: every matrix is resident at once, each with its own barrier,
    so ``depth`` is the number of matrices.  Otherwise the matrices stream
    through a ring of ``depth`` stages of ``stage_floats`` each, in tiles of
    ``tiles[i]`` rows of matrix i."""
    rows: int
    whole: bool
    depth: int
    stage_floats: int
    tiles: tuple
    n_tiles: int
    smem_bytes: int


def _head_bytes(n_bar: int, n_seg: int) -> int:
    """The mbarriers, then the matrix table (``struct S2Seg``), each on 16
    bytes."""
    return -(-8 * n_bar // 16) * 16 + -(-4 * len(SEG_FIELDS) * n_seg // 16) * 16


def _warp_floats(pack: Stage2Pack, k: int) -> int:
    """One warp's activations (one row of the micro-batch), carved in the
    kernel in this order: three row buffers of ``ld``; the slot embeddings
    and the typed towers' output; GAT's K + 1 scores; the slot mask,
    weights and types, and the typed towers' slot list."""
    n = 3 * pack.ld + k * pack.h * (1 + pack.typed) + (k + 1) * pack.gat
    return _align4(n + 4 * k)


def _act_floats(pack: Stage2Pack, rows: int, k: int) -> int:
    return rows * _warp_floats(pack, k)


def stage2_plan(pack: Stage2Pack, k: int, optin: int) -> Stage2Plan:
    """Shared memory for ``pack`` at K slots within ``optin`` bytes per block.

    Takes the most rows per block (up to ROWS_PER_BLOCK) at which every
    matrix fits at once; failing that, a ring of RING_DEPTH stages, each as
    large as the largest matrix or, when that does not fit, tiles of whole
    rows.  Depends on the widths only, never on the batch."""
    sizes = [s.rows * s.stride for s in pack.segments]
    n_seg = len(sizes)
    row_choices = [ROWS_PER_BLOCK >> i for i in range(ROWS_PER_BLOCK.bit_length())]
    for rows in row_choices:
        nbytes = (_head_bytes(n_seg + 1, n_seg)
                  + 4 * (pack.vec_floats + sum(sizes) + _act_floats(pack, rows, k)))
        if nbytes <= optin:
            return Stage2Plan(rows, True, n_seg, 0, tuple(s.rows for s in pack.segments),
                              n_seg, nbytes)
    for rows in row_choices:
        fixed = (_head_bytes(RING_DEPTH + 1, n_seg)
                 + 4 * (pack.vec_floats + _act_floats(pack, rows, k)))
        stage = min(max(sizes), (optin - fixed) // (4 * RING_DEPTH) // 4 * 4)
        tiles = tuple(min(s.rows, stage // s.stride) for s in pack.segments)
        if stage > 0 and min(tiles) >= 1:
            n_tiles = sum(-(-s.rows // t) for s, t in zip(pack.segments, tiles))
            return Stage2Plan(rows, False, RING_DEPTH, stage, tiles, n_tiles,
                              fixed + 4 * RING_DEPTH * stage)
    raise ValueError(f"stage2_score: H={pack.h}, K={k} do not fit {optin} bytes of shared memory")


# ----------------------------------------------------------------- launch

#: the ints of ``struct S2Seg`` in ``csrc/stage2_score.cu``, one row of the
#: matrix table per layer
SEG_FIELDS = ("off", "rows", "cols", "stride", "slices", "tile", "bias", "bias2", "relu", "role",
              "quads")


class _S2Args(ctypes.Structure):
    """Mirror of ``struct S2Args`` in ``csrc/stage2_score.cu``."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in
         ("emb", "mask", "feats", "slot_type", "pack", "out")]
        + [("table", ctypes.c_void_p), ("seg0_floats", ctypes.c_int)]
        + [(name, ctypes.c_int) for name in (
            "v_u_src", "v_u_dst", "v_a_et", "B", "K", "H", "F", "gat", "ld", "n_seg",
            "vec_floats", "mat_floats", "rows", "act_floats", "whole", "depth", "stage_floats",
            "n_tiles", "smem_bytes")]
    )


@functools.cache
def smem_optin(device_index: int) -> int:
    """Shared memory a block may opt in to on this card, in bytes."""
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


@functools.cache
def _allow_smem(device_index: int) -> None:
    """Raise the kernel's dynamic shared-memory limit to the opt-in, once
    per card (the limit is one value per kernel, not one per size)."""
    nbytes = smem_optin(device_index)
    with torch.cuda.device(device_index):
        rc = load_library().lib.stage2_score_configure(nbytes)
    if rc != 0:
        raise RuntimeError(f"stage2_score: cannot allow {nbytes} bytes of shared memory: "
                           f"cudaError_t {rc}")


def _template(pack: Stage2Pack, k: int, dev: torch.device) -> _S2Args:
    """The argument struct for ``pack`` at K slots, all but the batch's
    pointers and B, and the matrix table in device memory (the kernel copies
    it into shared memory); built once per (K, card), the struct copied for
    each launch."""
    key = (k, dev.index)
    if key not in pack._args:
        plan = stage2_plan(pack, k, smem_optin(dev.index))
        a = _S2Args()
        a.pack = pack.buffer.data_ptr()
        v = pack.vectors
        rows = []
        for s, tile in zip(pack.segments, plan.tiles):
            bias = [v[name][0] for name in s.bias] + [-1, -1]
            rows.append((s.off, s.rows, s.cols, s.stride, s.slices, tile, bias[0], bias[1],
                         int(s.relu), ROLES.index(s.role), s.quads))
        table = torch.tensor(rows, dtype=torch.int32, device=dev)
        first = pack.segments[0]
        a.seg0_floats = first.rows * first.stride
        a.table = table.data_ptr()
        if pack.gat:
            a.v_u_src, a.v_u_dst, a.v_a_et = v["u_src"][0], v["u_dst"][0], v["a_et"][0]
        a.K, a.H, a.F, a.gat = k, pack.h, pack.f, int(pack.gat)
        a.ld, a.n_seg, a.vec_floats = pack.ld, len(pack.segments), pack.vec_floats
        a.mat_floats = pack.buffer.numel() - pack.vec_floats
        a.rows, a.act_floats = plan.rows, _warp_floats(pack, k)
        a.whole, a.depth = int(plan.whole), plan.depth
        a.stage_floats, a.n_tiles, a.smem_bytes = plan.stage_floats, plan.n_tiles, plan.smem_bytes
        _allow_smem(dev.index)
        pack._args[key] = (a, table)
    return pack._args[key][0]


def stage2_score_cuda(entity_emb, emb_mask, order_feats, pack: Stage2Pack,
                      slot_type=None) -> torch.Tensor:
    """Launch the fused kernel: ``(emb [B,K,H], mask [B,K], feats [B,F]) ->
    logits [B]``, float32, contiguous, on one CUDA device.  ``pack`` comes
    from :func:`pack_stage2_params` on the same device.  ``slot_type``
    (int32 ``[B, K]`` type codes, -1 = untyped/padding slot) is required
    exactly when the pack is typed."""
    f32 = (torch.float32,)
    check_tensor(entity_emb, "entity_emb", f32)
    if entity_emb.dim() != 3:
        raise ValueError(f"entity_emb must be [B, K, H], got {tuple(entity_emb.shape)}")
    b, k, h = entity_emb.shape
    dev = entity_emb.device
    if h != pack.h:
        raise ValueError(f"entity_emb has H={h}, the weights H={pack.h}")
    check_tensor(emb_mask, "emb_mask", f32, (b, k), dev)
    check_tensor(order_feats, "order_feats", f32, (b, pack.f), dev)
    check_tensor(pack.buffer, "pack.buffer", f32, device=dev)
    if pack.typed != (slot_type is not None):
        raise ValueError("slot_type is required exactly when the weights are typed")
    if pack.typed:
        check_tensor(slot_type, "slot_type", (torch.int32,), (b, k), dev)
    if k < 1:
        raise ValueError("stage2_score needs K >= 1 slots")

    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    args = _S2Args.from_buffer_copy(_template(pack, k, dev))
    args.emb, args.mask, args.feats = (entity_emb.data_ptr(), emb_mask.data_ptr(),
                                       order_feats.data_ptr())
    args.slot_type = slot_type.data_ptr() if pack.typed else None
    args.out, args.B = out.data_ptr(), b
    with torch.cuda.device(dev):
        rc = load_library().lib.stage2_score_f32(ctypes.addressof(args),
                                                 stream_ptr(entity_emb))
    check_launch(rc, "stage2_score")
    return out

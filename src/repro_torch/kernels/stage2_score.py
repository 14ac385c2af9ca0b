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
order as the kernel ABI, so one flattening feeds both the kernel and its
plain version ``kernels.ref.stage2_score_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check_launch, check_tensor, load_library, stream_ptr

MAX_MLP = 8          # extra MLP layers the kernel's argument struct holds
ROWS_PER_BLOCK = 4   # micro-batch rows per thread block (fewer if smem is short)


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


class _S2Args(ctypes.Structure):
    """Mirror of ``struct S2Args`` in ``csrc/stage2_score.cu``."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "emb", "mask", "feats", "slot_type", "w_in", "b_in", "type_row",
            "tower_w", "tower_b", "typed_w", "typed_b", "w_self", "w_nbr",
            "b_last", "w_gat", "a_src", "a_dst", "a_et", "w0g", "w0f", "b0")]
        + [("mlp_w", ctypes.c_void_p * MAX_MLP),
           ("mlp_b", ctypes.c_void_p * MAX_MLP),
           ("out", ctypes.c_void_p),
           ("mlp_dim", ctypes.c_int * (MAX_MLP + 1))]
        + [(name, ctypes.c_int) for name in (
            "B", "K", "H", "F", "n_tower", "n_types", "gat", "n_extra", "rows",
            "wcap")]
    )


def stage2_score_cuda(entity_emb, emb_mask, order_feats, flat,
                      gnn_type: str = "gcn", slot_type=None) -> torch.Tensor:
    """Launch the fused kernel: ``(emb [B,K,H], mask [B,K], feats [B,F]) ->
    logits [B]``, float32, contiguous, on one CUDA device.  ``flat`` comes
    from :func:`flatten_stage2_params`.  ``slot_type`` (int32 ``[B, K]``
    type codes, -1 = untyped/padding slot) selects the typed variant, whose
    ``flat`` carries the per-type tower weights."""
    f32 = (torch.float32,)
    check_tensor(entity_emb, "entity_emb", f32)
    if entity_emb.dim() != 3:
        raise ValueError(f"entity_emb must be [B, K, H], got {tuple(entity_emb.shape)}")
    b, k, h = entity_emb.shape
    dev = entity_emb.device
    check_tensor(emb_mask, "emb_mask", f32, (b, k), dev)
    if order_feats.dim() != 2 or order_feats.shape[0] != b:
        raise ValueError(f"order_feats must be [{b}, F], got {tuple(order_feats.shape)}")
    f = order_feats.shape[1]
    check_tensor(order_feats, "order_feats", f32, (b, f), dev)
    typed = slot_type is not None
    if typed:
        check_tensor(slot_type, "slot_type", (torch.int32,), (b, k), dev)
    p = unpack_stage2_params(flat, gnn_type, typed)
    n_tower = p["tower_w"].shape[0]
    m = [p["w0g"].shape[1]] + [w.shape[1] for w, _ in p["mlp"]]
    if len(p["mlp"]) >= MAX_MLP:
        raise ValueError(f"at most {MAX_MLP - 1} extra MLP layers, got {len(p['mlp'])}")
    shapes = {"w_in": (f, h), "b_in": (1, h), "type_row": (1, h),
              "tower_w": (n_tower, h, h), "tower_b": (n_tower, h),
              "w_self": (h, h), "b_last": (1, h),
              "w0g": (h, m[0]), "w0f": (f, m[0]), "b0": (1, m[0])}
    if typed:
        n_types = p["typed_w"].shape[0]
        shapes.update(typed_w=(n_types, h, h), typed_b=(n_types, h))
    if gnn_type == "gat":
        shapes.update(w_gat=(h, h), a_src=(h, 1), a_dst=(h, 1), a_et=(1, 1))
    else:
        shapes.update(w_nbr=(h, h))
    for name, shape in shapes.items():
        check_tensor(p[name], name, f32, shape, dev)
    for i, (w, bias) in enumerate(p["mlp"]):
        check_tensor(w, f"mlp[{i + 1}].w", f32, (m[i], m[i + 1]), dev)
        check_tensor(bias, f"mlp[{i + 1}].b", f32, (1, m[i + 1]), dev)

    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    args = _S2Args()
    args.emb, args.mask, args.feats = (entity_emb.data_ptr(), emb_mask.data_ptr(),
                                       order_feats.data_ptr())
    args.slot_type = slot_type.data_ptr() if typed else None
    for name in shapes:
        setattr(args, name, p[name].data_ptr())
    for i, (w, bias) in enumerate(p["mlp"]):
        args.mlp_w[i], args.mlp_b[i] = w.data_ptr(), bias.data_ptr()
    for i, width in enumerate(m):
        args.mlp_dim[i] = width
    args.out = out.data_ptr()
    args.B, args.K, args.H, args.F = b, k, h, f
    args.n_tower = n_tower
    args.n_types = p["typed_w"].shape[0] if typed else 0
    args.gat = int(gnn_type == "gat")
    args.n_extra = len(p["mlp"])
    args.rows = ROWS_PER_BLOCK
    with torch.cuda.device(dev):
        rc = load_library().lib.stage2_score_f32(ctypes.addressof(args),
                                                 stream_ptr(entity_emb))
    check_launch(rc, "stage2_score")
    return out

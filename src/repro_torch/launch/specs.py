"""Meta-tensor stand-ins for every model input (nothing allocated).

The reference's ``repro.launch.specs``, with meta tensors in place of
``jax.ShapeDtypeStruct``s.  ``input_specs(cfg, shape)`` returns the
abstract arguments the step function for that input-shape kind consumes:

  train    -> {'batch': {'tokens', 'labels', [vision|frames]}}
  prefill  -> {'batch': {'tokens', [vision|frames]}}
  decode   -> {'token', 'cache'}   (the cache from ``init_cache`` on meta;
              its ``pos`` is the port's Python int, which stands for the
              reference's int32 scalar)

Modality frontends are stubs, as in the reference: VLM vision tokens and
audio frames arrive as precomputed d_model embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import torch_dtype
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.models.transformer import init_cache

# frontend stub sizes
AUDIO_FRAMES_TRAIN = 4096        # ~80s of 20ms frames
AUDIO_FRAMES_SERVE = 4096


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras_spec(cfg: ArchConfig, batch: int, seq: int) -> dict:
    dtype = torch_dtype(cfg.dtype)
    out = {}
    if cfg.arch_type == "vlm":
        out["vision"] = _meta((batch, cfg.num_vision_tokens, cfg.d_model), dtype)
    if cfg.arch_type == "audio":
        out["frames"] = _meta((batch, min(seq, AUDIO_FRAMES_TRAIN), cfg.d_model), dtype)
    return out


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {
            "tokens": _meta((b, s), torch.int32),
            "labels": _meta((b, s), torch.int32),
        }
        batch.update(_extras_spec(cfg, b, s))
        return {"batch": batch}
    if shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
        batch.update(_extras_spec(cfg, b, s))
        return {"batch": batch}
    if shape.kind == "decode":
        extra_shapes = {}
        if cfg.arch_type == "vlm":
            extra_shapes["vision_len"] = cfg.num_vision_tokens
        if cfg.arch_type == "audio":
            extra_shapes["memory_len"] = AUDIO_FRAMES_SERVE
        cache = init_cache(cfg, b, s, extra_shapes, device="meta")
        return {"token": _meta((b,), torch.int32), "cache": cache}
    raise ValueError(shape.kind)


def supports_shape(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (the reference's skip
    table)."""
    if shape.name != "long_500k":
        return True, ""
    if cfg.arch_type in ("ssm", "hybrid"):
        return True, ""
    if cfg.window is not None:
        return True, ""   # sliding-window bounds decode work
    return False, (
        f"{cfg.name}: pure full attention — long_500k skipped per DESIGN.md "
        "(no sub-quadratic variant in the baseline)"
    )

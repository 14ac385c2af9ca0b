"""The model zoo of the port: configurations and the composable model for
the groups it has (``decoder``, dense and MoE; ``mamba``, ``zamba_super``);
and the fraud path's hybrid GNN -> GBDT head (``models.hybrid``), whose
names resolve lazily (PEP 562): ``models.hybrid`` imports ``core.lnn``,
which imports ``kernels.ops``."""
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "INPUT_SHAPES",
    "ArchConfig",
    "HybridModel",
    "InputShape",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "is_hybrid_checkpoint",
    "load_hybrid",
    "prefill",
    "save_hybrid",
    "train_hybrid",
]

_HYBRID = ("HybridModel", "is_hybrid_checkpoint", "load_hybrid", "save_hybrid",
           "train_hybrid")


def __getattr__(name: str):
    if name not in _HYBRID:
        raise AttributeError(f"module 'repro_torch.models' has no attribute {name!r}")
    from repro_torch.models import hybrid

    value = getattr(hybrid, name)
    globals()[name] = value    # cache: next access skips __getattr__
    return value

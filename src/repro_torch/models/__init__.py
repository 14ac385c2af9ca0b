"""The model zoo of the port: configurations and the composable model for
the groups it has (``mamba``, ``zamba_super``)."""
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
    "InputShape",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
]

"""Architecture registry of the port.

The ids and aliases are the reference's (``repro.configs``), and so are
the configurations, copied value for value: ``zamba2-1.2b`` (hybrid),
``mamba2-370m`` (ssm), the ``decoder`` group's dense ``granite-3-2b``,
``olmo-1b``, ``qwen1.5-32b`` and ``yi-34b`` and MoE
``phi3.5-moe-42b-a6.6b`` and ``mixtral-8x22b``, the vlm
``llama-3.2-vision-90b`` and the audio encoder-decoder
``seamless-m4t-medium``; and the paper's own model, ``lnn_fraud``.
The port alone also has ``granite-4.0-h-small`` (``PORT_ONLY``), which
``get_config`` resolves and ``all_configs`` leaves out.
"""
from __future__ import annotations

import importlib

#: the reference's architecture ids
ARCH_IDS = [
    "mamba2_370m",
    "granite_3_2b",
    "llama_3_2_vision_90b",
    "yi_34b",
    "phi3_5_moe",
    "olmo_1b",
    "zamba2_1_2b",
    "seamless_m4t_medium",
    "mixtral_8x22b",
    "qwen1_5_32b",
]

# canonical CLI names (dashes) -> module names
CLI_ALIASES = {
    "mamba2-370m": "mamba2_370m",
    "granite-3-2b": "granite_3_2b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "yi-34b": "yi_34b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "olmo-1b": "olmo_1b",
    "zamba2-1.2b": "zamba2_1_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen1.5-32b": "qwen1_5_32b",
}

#: configurations of the port that the reference does not have: CLI name ->
#: module name
PORT_ONLY = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}


def get_config(arch: str):
    """The ``ArchConfig`` of ``arch`` (a CLI name or a module name), or the
    paper's ``LNNConfig`` for ``"lnn_fraud"``."""
    mod_name = {**CLI_ALIASES, **PORT_ONLY}.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS and mod_name not in PORT_ONLY.values() \
            and mod_name != "lnn_fraud":
        raise KeyError(f"unknown arch {arch!r}; known: {sorted({**CLI_ALIASES, **PORT_ONLY})}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_configs():
    """``{arch id: config}`` for every zoo id, as the reference's."""
    return {aid: get_config(aid) for aid in ARCH_IDS}

"""Architecture registry of the port.

The ids and aliases are the reference's (``repro.configs``).  The port has
the configurations whose block programs it runs, copied value for value:
``zamba2-1.2b`` (hybrid), ``mamba2-370m`` (ssm), the ``decoder`` group's
dense ``granite-3-2b``, ``olmo-1b``, ``qwen1.5-32b`` and ``yi-34b`` and MoE
``phi3.5-moe-42b-a6.6b`` and ``mixtral-8x22b``; and the paper's own model,
``lnn_fraud``.  The other known ids (``llama-3.2-vision-90b``,
``seamless-m4t-medium``) raise ``NotImplementedError``; ``ROADMAP.md``
(queue 1 item 5) lists the zoo's remaining groups in the order they are to
be ported.
"""
from __future__ import annotations

import importlib

#: the reference's architecture ids, and those the port has
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
PORTED_IDS = ("mamba2_370m", "granite_3_2b", "yi_34b", "phi3_5_moe", "olmo_1b",
              "zamba2_1_2b", "mixtral_8x22b", "qwen1_5_32b")

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


def get_config(arch: str):
    """The ``ArchConfig`` of ``arch`` (a CLI name or a module name), or the
    paper's ``LNNConfig`` for ``"lnn_fraud"``."""
    mod_name = CLI_ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS and mod_name != "lnn_fraud":
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(CLI_ALIASES)}")
    if mod_name in ARCH_IDS and mod_name not in PORTED_IDS:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: the port serves the ssm, hybrid, dense "
            f"and moe configurations {sorted(PORTED_IDS)}; ROADMAP.md queue 1 item 5 "
            "lists the zoo's remaining groups in order")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_configs():
    """``{arch id: config}`` for every zoo id, as the reference's; raises
    ``NotImplementedError`` (through :func:`get_config`) while an id is
    unported, never returning a subset."""
    return {aid: get_config(aid) for aid in ARCH_IDS}

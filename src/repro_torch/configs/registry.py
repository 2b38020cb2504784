"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

Each ``<arch>.py`` module defines ``CONFIG`` with the exact published
dimensions (source cited in ``ModelConfig.source``). ``--arch <id>`` in the
launchers resolves through this registry.
"""

from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = [
    "minicpm_2b",
    "qwen3_32b",
    "gemma3_12b",
    "grok1_314b",
    "zamba2_7b",
    "llava_next_mistral_7b",
    "granite_moe_3b_a800m",
    "seamless_m4t_medium",
    "nemotron4_15b",
    "xlstm_350m",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def canonical(name: str) -> str:
    key = name.replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIAS)}")
    return key


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCH_IDS)

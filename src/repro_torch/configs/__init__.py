"""Architecture registry, the port's copy of ``repro.configs``:
``get_config(arch_id)`` / ``--arch <id>``.

One module per assigned architecture with the exact published config, plus
``smoke_config()`` — a reduced same-family config for CPU tests. The data
is ``repro``'s (``tests/test_torch_models.py`` holds every field equal);
the port serves all ten.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHITECTURES: List[str] = [
    "arctic_480b",
    "olmoe_1b_7b",
    "falcon_mamba_7b",
    "command_r_35b",
    "qwen3_4b",
    "gemma3_27b",
    "mistral_large_123b",
    "hymba_1_5b",
    "phi_3_vision_4_2b",
    "seamless_m4t_large_v2",
]


def canonical(arch: str) -> str:
    a = arch.replace("-", "_").replace(".", "_")
    if a not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHITECTURES}")
    return a


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHITECTURES}

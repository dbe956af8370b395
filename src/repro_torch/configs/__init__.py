"""Architecture registry: the ten LM-zoo archs and the paper's own SNN.

Each arch module exposes CONFIG (a ``models.config.ModelConfig``) with the
exact published numbers; ``get(name)`` resolves by arch id (dashes ok).
The SNN's configurations live in ``configs/collision_snn.py``.
"""

from __future__ import annotations

import importlib
from typing import List

ARCH_IDS: List[str] = [
    "mixtral-8x7b",
    "granite-moe-1b-a400m",
    "mamba2-130m",
    "stablelm-1.6b",
    "codeqwen1.5-7b",
    "yi-34b",
    "minicpm3-4b",
    "recurrentgemma-2b",
    "phi-3-vision-4.2b",
    "musicgen-medium",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get(arch_id: str):
    """Return the ModelConfig for an architecture id."""
    if arch_id in ("collision-snn", "collision_snn"):
        raise ValueError(
            "collision-snn is an SNNConfig; use repro_torch.configs.collision_snn"
        )
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def all_configs():
    return {a: get(a) for a in ARCH_IDS}

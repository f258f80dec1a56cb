"""Config registry: ``--arch <id>`` resolution, the reference's ten
architectures (dense, MoE, recurrent, encoder and VLM families)."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "phi3-mini-3.8b", "yi-34b", "smollm-360m", "qwen3-32b", "hubert-xlarge",
    "deepseek-moe-16b", "granite-moe-3b-a800m", "rwkv6-1.6b",
    "recurrentgemma-9b", "internvl2-26b",
]
PORTED_ARCH_IDS = tuple(ARCH_IDS)


def get_config(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.ARCH


def all_configs() -> dict:
    """``{arch id: ArchConfig}`` for every architecture, in ``ARCH_IDS``
    order."""
    return {a: get_config(a) for a in ARCH_IDS}


from .base import (SHAPES, SINGLE, ArchConfig, ShapeCell,  # noqa: E402,F401
                   ShardPlan, make_plan)

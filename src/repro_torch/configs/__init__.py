"""Config registry: ``--arch <id>`` resolution.

The reference knows ten architectures; the port has the ones whose blocks
it runs (the dense, MoE and recurrent families).  The others (the encoder
and VLM families) raise, naming what is ported.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "phi3-mini-3.8b", "yi-34b", "smollm-360m", "qwen3-32b", "hubert-xlarge",
    "deepseek-moe-16b", "granite-moe-3b-a800m", "rwkv6-1.6b",
    "recurrentgemma-9b", "internvl2-26b",
]
PORTED_ARCH_IDS = (
    "phi3-mini-3.8b", "yi-34b", "smollm-360m", "qwen3-32b",
    "deepseek-moe-16b", "granite-moe-3b-a800m", "rwkv6-1.6b",
    "recurrentgemma-9b",
)


def get_config(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    if arch_id not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported (ported: "
            f"{', '.join(PORTED_ARCH_IDS)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.ARCH


from .base import SINGLE, ArchConfig, ShardPlan  # noqa: E402,F401

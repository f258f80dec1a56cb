"""Architecture configuration (port of ``repro/configs/base.py``).

Only the dense family is ported: the fields its layers read, the derived
sizes (``hd``, ``padded_vocab``, ``blocks_pattern``), ``smoke()`` for the
CPU tests, and the single-device sharding plan with its head padding.
The MoE, recurrent and modality fields of the reference wait for the
slices that port those blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import FP32, QuantConfig

VOCAB_PAD = 256  # pad vocab to a multiple of this (divisible by TP=16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense (the only ported family)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    window: Optional[int] = None
    pattern: Tuple[str, ...] = ("attn",)
    # activations / norms
    act: str = "swiglu"                     # swiglu | gelu
    tie_embeddings: bool = False
    # paper technique
    quant: QuantConfig = FP32
    # dtypes
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    banded_attn: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // VOCAB_PAD) * VOCAB_PAD

    @property
    def blocks_pattern(self) -> Tuple[str, ...]:
        """Full per-layer block-type sequence of length n_layers."""
        reps = -(-self.n_layers // len(self.pattern))
        return tuple((list(self.pattern) * reps)[: self.n_layers])

    def smoke(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU tests (the reference's smoke
        geometry: float32 compute)."""
        changes = dict(
            name=self.name + "-smoke",
            n_layers=max(2, 2 * len(self.pattern)),
            d_model=128, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256, head_dim=32, vocab=512,
            window=min(self.window, 64) if self.window else None,
            compute_dtype=torch.float32,
        )
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Sharding plan; the port runs on one device (``tp == 1``)."""

    tp: int = 1

    def padded_heads(self, n_heads: int) -> int:
        """Q heads padded to a TP multiple (zero-masked; math-exact)."""
        return -(-n_heads // self.tp) * self.tp


SINGLE = ShardPlan(tp=1)

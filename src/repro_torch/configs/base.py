"""Architecture configuration (port of ``repro/configs/base.py``).

The dense, MoE, recurrent (RWKV-6, RG-LRU), encoder and VLM families:
the fields their layers read (the encoder's frame input and the VLM's
patch embeddings among them), the derived sizes (``hd``,
``padded_vocab``, ``blocks_pattern``), ``smoke()`` for the CPU tests
(reducing every field as the reference's does), and the single-device
sharding plan with its head padding.  The reference's shape cells
(``ShapeCell``, ``SHAPES``, ``skip_shapes``) and its training and
analysis toggles are left out: nothing in the port reads them.
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
    family: str                     # dense | moe | rwkv | rglru | encoder | vlm
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
    window: Optional[int] = None            # local-attention window (rglru)
    pattern: Tuple[str, ...] = ("attn",)    # block pattern, tiled over n_layers
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # activations / norms
    act: str = "swiglu"                     # swiglu | gelu
    tie_embeddings: bool = False
    # modality stubs
    n_patches: int = 0                      # vlm: vision tokens prepended
    vit_dim: int = 0                        # vlm: stub patch-embedding dim
    frame_input: bool = False               # audio: frame embeddings replace tokens
    frame_dim: int = 0                      # audio: stub frame-feature dim
    # recurrent families
    lru_width: Optional[int] = None
    conv_width: int = 4
    rwkv_head_dim: int = 64
    lora_rank: int = 32
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

    def n_blocks_of(self, kind: str) -> int:
        return sum(1 for b in self.blocks_pattern if b == kind)

    def smoke(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU tests (the reference's smoke
        geometry: float32 compute)."""
        changes = dict(
            name=self.name + "-smoke",
            n_layers=max(2, 2 * len(self.pattern)),
            d_model=128, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256, head_dim=32, vocab=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            expert_d_ff=64 if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            lru_width=128 if self.lru_width else None,
            n_patches=16 if self.n_patches else 0,
            vit_dim=64 if self.vit_dim else 0,
            frame_dim=64 if self.frame_dim else 0,
            lora_rank=8,
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

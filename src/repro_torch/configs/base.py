"""Architecture configuration (port of ``repro/configs/base.py``).

The dense, MoE, recurrent (RWKV-6, RG-LRU), encoder and VLM families:
the fields their layers read (the encoder's frame input and the VLM's
patch embeddings among them), the derived sizes (``hd``,
``padded_vocab``, ``blocks_pattern``), ``smoke()`` for the CPU tests
(reducing every field as the reference's does), the reference's shape cells
(``ShapeCell``, ``SHAPES``: the abstract batches of ``launch.steps``),
the training toggle the port reads (``remat``: recompute each
block's activations in the backward), the analysis toggles the dry run
sets (``launch.dryrun``; the reference's defaults), each config's
``skip_shapes`` and ``shapes()``, and the sharding plan of a device mesh
(``ShardPlan``, ``make_plan``: logical axes to mesh axes, read by
``distributed.sharding``).

Of the toggles, ``rglru_assoc`` (RG-LRU's log-step scan),
``full_attn_analysis`` (materialized attention logits), ``act_scale``
(a static activation scale for the prequantized serve ``qdense``) and
``constrain_acts`` (the residual stream batch-split on a mesh) change
what runs.  ``scan_layers`` and ``remat_prevent_cse`` are accepted and
have no effect: the layers always run as a Python loop (the reference
scans them when ``scan_layers``), and eager PyTorch has no common
subexpression elimination for ``remat_prevent_cse`` to stop.  The
reference's hill-climb toggles ``bf16_logits`` and ``ce_where_mask`` are
left out: the dry run sets neither, and the port keeps the reference's
default forms of both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import FP32, QuantConfig

VOCAB_PAD = 256  # pad vocab to a multiple of this (divisible by TP=16)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""

    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


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
    # training
    remat: bool = True
    # analysis/runtime toggles (launch.dryrun sets the first three; see
    # the module docstring for the two without an effect here)
    scan_layers: bool = True
    full_attn_analysis: bool = False
    rglru_assoc: bool = False
    remat_prevent_cse: bool = False
    act_scale: float = 0.0            # >0: static activation scale of the
                                      # prequantized serve qdense
    constrain_acts: bool = False      # residual stream batch-split on a mesh
    # which shape cells apply
    skip_shapes: Tuple[str, ...] = ("long_500k",)

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

    def shapes(self):
        """The shape cells this config runs (``SHAPES`` less
        ``skip_shapes``), in ``SHAPES`` order."""
        for name, cell in SHAPES.items():
            if name not in self.skip_shapes:
                yield cell

    def smoke(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU tests (the reference's smoke
        geometry: float32 compute, no remat)."""
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
            remat=False,
        )
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Logical-axis -> mesh-axis mapping plus padding-relevant sizes.

    tp   = size of the "model" axis (TP/EP degree)
    fsdp = size of the "data" axis (FSDP/ZeRO param sharding degree)
    dp   = total batch-sharding degree (pod*data)
    """

    tp: int = 1
    fsdp: int = 1
    dp: int = 1
    batch_axes: Tuple[str, ...] = ()        # mesh axes for the batch dim
    rules: Tuple[Tuple[str, Optional[str]], ...] = ()

    def axis_for(self, logical: str):
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def padded_heads(self, n_heads: int) -> int:
        """Q heads padded to a TP multiple (zero-masked; math-exact)."""
        return -(-n_heads // self.tp) * self.tp

    def shard_kv(self, n_kv: int) -> bool:
        return self.tp > 1 and n_kv % self.tp == 0

    def shard_experts(self, n_experts: int) -> bool:
        return self.tp > 1 and n_experts > 0 and n_experts % self.tp == 0


SINGLE = ShardPlan(
    tp=1, fsdp=1, dp=1, batch_axes=(),
    rules=(("vocab", None), ("heads", None), ("kv_heads", None), ("mlp", None),
           ("expert", None), ("embed", None), ("layers", None)),
)


def make_plan(mesh_shape: dict, *, inference: bool = False) -> ShardPlan:
    """The sharding plan of a mesh ``{axis: size}`` dict.

    ``inference=True`` drops the FSDP rule: with no optimizer state there
    is no per-device memory pressure, and FSDP's per-layer parameter
    all-gathers would dominate the serve path's collectives."""
    tp = mesh_shape.get("model", 1)
    fsdp = mesh_shape.get("data", 1)
    pod = mesh_shape.get("pod", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh_shape)
    return ShardPlan(
        tp=tp,
        fsdp=fsdp,
        dp=pod * fsdp,
        batch_axes=batch_axes,
        rules=(
            ("vocab", "model"),
            ("heads", "model"),
            ("kv_heads", "model"),      # applied only if divisible (shard_kv)
            ("mlp", "model"),
            ("expert", "model"),        # applied only if divisible (shard_experts)
            ("embed", None if inference else "data"),  # FSDP/ZeRO param axis
            ("layers", None),
        ),
    )

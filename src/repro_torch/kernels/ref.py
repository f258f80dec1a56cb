"""Plain PyTorch oracles for the bit-plane kernels (port of
``repro/kernels/ref.py``): each kernel equals its oracle exactly."""
from __future__ import annotations

import torch

from repro_torch.core import bitplane
from repro_torch.core.and_accum import bitgemm_planes, level_gemm_exact
from repro_torch.core.quant import activation_levels


def bitgemm_ref(a_lv: torch.Tensor, w_lv: torch.Tensor, a_bits: int,
                w_bits: int) -> torch.Tensor:
    """Oracle for both bit-GEMM kernels: Eq. (1) on explicit planes."""
    return bitgemm_planes(a_lv.to(torch.int32), w_lv.to(torch.int32), a_bits,
                          w_bits)


def quantpack_ref(a: torch.Tensor, bits: int):
    """Oracle for the fused quantize + pack kernel: (M, K) float ->
    ``(levels int32 (M, K), planes int32 (bits, M, ceil(K/32)))``."""
    levels = activation_levels(a, bits)[0]
    return levels, bitplane.decompose_packed(levels, bits)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Oracle for the int8 matmul kernel (integers -> exact int32; floats
    -> float32)."""
    if not a.dtype.is_floating_point:
        return level_gemm_exact(a, b).to(torch.int32)
    return a.to(torch.float32) @ b.to(torch.float32)

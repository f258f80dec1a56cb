"""The level-GEMM arithmetic shared by both kernels and their plain versions
(port of the parts of ``repro/core/and_accum.py`` the CNN and LM slices
need).

With a = s_a * A (A unsigned levels) and w = s_w * (W - z_w):

    a @ w = s_a*s_w * (A @ W) - s_a*s_w*z_w * rowsum(A)

``dequant_epilogue`` is the single f32 epilogue expression; both CUDA
kernels compute it with explicitly rounded multiplies (no FMA contraction),
so a kernel and its plain version agree bit for bit.

The signed (transformer) path, :func:`quant_dense_forward_signed_pre`, has
no Pallas kernel in the reference: its level GEMM runs on XLA's int8
engine.  Here it is one library int8 product, ``torch._int_mm`` on centred
levels (:func:`centred_gemm_int`), exact in int32.
"""
from __future__ import annotations

import numpy as np
import torch

from .quant import (activation_levels_signed, activation_levels_signed_row,
                    signed_levels)



def int32_exact(k: int, a_bits: int, w_bits: int) -> bool:
    """The kernels' int32 accumulator cannot overflow:
    ``(2^a - 1)(2^w - 1) K < 2^31``."""
    return ((1 << a_bits) - 1) * ((1 << w_bits) - 1) * max(k, 1) < (1 << 31)


def epilogue_scales(a_bits: int, s_w, z_w) -> tuple[np.float32, np.float32]:
    """``(s, t)`` with ``s = f32(1/(2^a-1)) * s_w`` and ``t = s * z_w``, in
    float32 — computed on the host exactly as the reference kernel's
    wrapper computes them (``fused_qgemm.py:125-127``)."""
    s_a = np.float32(1.0 / ((1 << a_bits) - 1))
    s = np.float32(s_a * np.float32(s_w))
    return s, np.float32(s * np.float32(z_w))


def level_gemm_exact(a_lv: torch.Tensor, w_lv: torch.Tensor) -> torch.Tensor:
    """Exact integer level GEMM (M,K) x (K,N) -> float64 (M,N).

    float64 holds every product and partial sum exactly (they stay below
    2^31 < 2^53), and unlike an int64 matmul it runs on the card too, so
    the same oracle serves the CPU tests and the on-card comparison."""
    return a_lv.to(torch.float64) @ w_lv.to(torch.float64)


def dequant_epilogue(acc: torch.Tensor, rowsum: torch.Tensor, s, t
                     ) -> torch.Tensor:
    """``s * f32(acc) - t * f32(rowsum)[:, None]`` in float32, each
    operation rounded on its own.  ``s`` and ``t`` are float32 values; as
    Python scalars they enter a float32 op as float32, exactly."""
    return (acc.to(torch.float32) * float(s)
            - rowsum.to(torch.float32)[:, None] * float(t))


# torch._int_mm on the card (cuBLASLt int8) takes more than 16 rows, a row
# count in multiples of 8, and K, N in multiples of 8
_INT_MM_MIN_ROWS = 24


def centred_gemm_int(c_lv: torch.Tensor, w_lv: torch.Tensor) -> torch.Tensor:
    """Exact int32 product (M, K) x (K, N) of centred activation levels in
    [-128, 127] and int8 weight levels: one ``torch._int_mm``, its rows
    padded with zeros as cuBLASLt needs.  On an H100 (CUDA 12.8) cuBLASLt
    served SmolLM's K in {960, 2560}, N in {320, 960, 2560} and refused
    N=96, K=64."""
    m, k = c_lv.shape
    n = w_lv.shape[1]
    if w_lv.dtype != torch.int8:
        raise ValueError(f"centred_gemm_int: needs int8 weight levels, got "
                         f"{w_lv.dtype}")
    if k % 8 or n % 8:
        raise ValueError(f"centred_gemm_int: K={k} and N={n} must be "
                         f"multiples of 8 (torch._int_mm)")
    a8 = c_lv.to(torch.int8)
    rows = max(_INT_MM_MIN_ROWS, -(-m // 8) * 8)
    if rows > m:
        a8 = torch.cat([a8, a8.new_zeros((rows - m, k))])
    return torch._int_mm(a8, w_lv)[:m]


def quant_dense_forward_signed_pre(a: torch.Tensor, w_lv: torch.Tensor, s_w,
                                   z_w, a_bits: int, w_bits: int,
                                   a_scale=None) -> torch.Tensor:
    """Signed quantized dense with pre-quantized weights (the LM serve
    GEMM).  ``a`` (..., K) in the compute dtype; ``w_lv`` (K, N) int8
    levels; ``s_w``, ``z_w`` 0-d float32 tensors.

    With ``a = s_a (A - z_a)`` and ``w = s_w (W - z_w)`` the reference
    computes ``s_a s_w [A@W - z_w rowsum(A) - z_a colsum(W) + K z_a z_w]``.
    Here the product runs on the centred levels ``C = A - z_a`` (int8, so
    ``C@W`` is one ``torch._int_mm``), where the bracket is
    ``C@W - z_w rowsum(C)``: the same real number, and every term of both
    forms is an integer or half-integer far below 2^23, so both are exact
    in float32 and the results agree bit for bit.

    ``a_scale``: None (per-tensor dynamic absmax), ``'row'`` (per-row), or
    a float (a static calibrated scale; the levels then in float32)."""
    lead = a.shape[:-1]
    k = a.shape[-1]
    a2 = a.reshape(-1, k)
    if a_scale == "row":
        a_lv, s_a, _ = activation_levels_signed_row(a2, a_bits)
    elif a_scale is not None:
        s_a = torch.tensor(a_scale, dtype=torch.float32, device=a.device)
        a_lv = signed_levels(a2.float(), s_a, a_bits)
    else:
        a_lv, s_a, _ = activation_levels_signed(a2, a_bits)
    c_lv = a_lv - (1 << (a_bits - 1))
    acc = centred_gemm_int(c_lv, w_lv).to(torch.float32)
    rowsum = c_lv.sum(dim=-1, dtype=torch.int32).to(torch.float32)
    out = (acc - z_w * rowsum[:, None]) * (s_a.float() * s_w)
    return out.reshape(lead + (w_lv.shape[-1],)).to(a.dtype)

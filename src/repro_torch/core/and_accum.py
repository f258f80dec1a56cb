"""The level-GEMM arithmetic shared by both kernels and their plain versions
(port of the parts of ``repro/core/and_accum.py`` this slice needs).

With a = s_a * A (A unsigned levels) and w = s_w * (W - z_w):

    a @ w = s_a*s_w * (A @ W) - s_a*s_w*z_w * rowsum(A)

``dequant_epilogue`` is the single f32 epilogue expression; both CUDA
kernels compute it with explicitly rounded multiplies (no FMA contraction),
so a kernel and its plain version agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


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

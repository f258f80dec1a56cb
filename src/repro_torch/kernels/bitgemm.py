"""Packed AND + popcount bit-GEMM, the paper's Eq. (1) computed literally.

Port of ``repro/kernels/bitgemm.py`` (``bitgemm_packed_pallas``).  The CUDA
kernel is ``csrc/bitgemm.cu``; its source note says what bounds it on an
H100 and how it tiles.  :func:`bitgemm_packed` is the wrapper: a CPU tensor
takes :func:`bitgemm_packed_plain`, a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.and_accum import bitgemm_packed_planes, int32_exact
from repro_torch.core.bitplane import LANE
from . import _lib

NAME = "bitgemm_packed"


def bitgemm_packed_plain(a_planes: torch.Tensor, w_planes: torch.Tensor, *,
                         a_bits: int, w_bits: int) -> torch.Tensor:
    """Plain PyTorch version: AND, popcount, sum over the words, shift by
    m+n, accumulate (the AND intermediate a block of rows at a time)."""
    return bitgemm_packed_planes(a_planes, w_planes)


def _check(a: torch.Tensor, w: torch.Tensor, a_bits: int, w_bits: int) -> None:
    if a.ndim != 3 or w.ndim != 3 or a.shape[2] != w.shape[2]:
        raise ValueError(f"bitgemm_packed: needs (a_bits, M, Kw) and (w_bits, "
                         f"N, Kw) planes, got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    if (a.shape[0], w.shape[0]) != (a_bits, w_bits):
        raise ValueError(f"bitgemm_packed: {a.shape[0]} and {w.shape[0]} "
                         f"planes for a_bits={a_bits}, w_bits={w_bits}")
    if a.dtype != torch.int32 or w.dtype != torch.int32:
        raise TypeError(f"bitgemm_packed: needs int32 words, got {a.dtype} "
                        f"and {w.dtype}")
    if a.device != w.device:
        raise ValueError(f"bitgemm_packed: planes on {a.device} and "
                         f"{w.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("bitgemm_packed: planes must be contiguous")
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"bitgemm_packed: bit widths must be 1..8, got "
                         f"a={a_bits} w={w_bits}")
    if not int32_exact(LANE * a.shape[2], a_bits, w_bits):
        raise ValueError(f"bitgemm_packed: int32 accumulator may overflow at "
                         f"Kw={a.shape[2]} words, a_bits={a_bits}, "
                         f"w_bits={w_bits}")


def bitgemm_packed(a_planes: torch.Tensor, w_planes: torch.Tensor, *,
                   a_bits: int, w_bits: int) -> torch.Tensor:
    """(a_bits, M, Kw) and (w_bits, N, Kw) int32 words -> (M, N) int32
    ``sum_mn 2^(m+n) popcount(A_m & W_n)``."""
    _check(a_planes, w_planes, a_bits, w_bits)
    if a_planes.device.type == "cpu":
        return bitgemm_packed_plain(a_planes, w_planes, a_bits=a_bits,
                                    w_bits=w_bits)
    if a_planes.device.type != "cuda":
        raise ValueError(f"bitgemm_packed: unsupported device "
                         f"{a_planes.device}")
    _, m, kw = a_planes.shape
    n = w_planes.shape[1]
    if kw == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=a_planes.device)
    out = torch.empty((m, n), dtype=torch.int32, device=a_planes.device)
    if m == 0 or n == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _lib.launcher(NAME, [p, p, p, i, i, i, i, i, p])
    with torch.cuda.device(a_planes.device):
        stream = torch.cuda.current_stream(a_planes.device).cuda_stream
        err = launch(a_planes.data_ptr(), w_planes.data_ptr(), out.data_ptr(),
                     m, n, kw, a_bits, w_bits, stream)
    _lib.check_launch(NAME, err)
    _lib.LAUNCHES[NAME] += 1
    return out

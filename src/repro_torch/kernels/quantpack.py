"""Fused DoReFa quantize + bit-plane pack.

Port of ``repro/kernels/quantpack.py`` (``quantize_pack_pallas``).  The
CUDA kernel is ``csrc/quantpack.cu``; its source note says what bounds it
on an H100 and how its two kernels load and pack.  :func:`quantize_pack` is
the wrapper: a CPU tensor takes :func:`quantize_pack_plain`, a CUDA
tensor launches the kernel or raises.

Two forms share the kernel: float32 activations in (levels and planes
out), and uint8 levels in (planes out; the levels are the input).  The
faithful engine packs its activation levels with the second.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitplane
from repro_torch.core.quant import activation_levels
from . import _lib

NAME = "quantize_pack"


def quantize_pack_plain(a: torch.Tensor, bits: int):
    """Plain PyTorch version: ``(levels uint8 (M, K), planes int32 (bits,
    M, ceil(K/32)))``; uint8 input is taken as the levels."""
    lv = a if a.dtype == torch.uint8 else activation_levels(a, bits)[0].to(
        torch.uint8)
    return lv, bitplane.decompose_packed(lv, bits)


def _check(a: torch.Tensor, bits: int) -> None:
    if a.ndim != 2:
        raise ValueError(f"quantize_pack: needs (M, K), got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"quantize_pack: needs float32 activations or uint8 "
                        f"levels, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("quantize_pack: input must be contiguous")
    if not 1 <= bits <= 8:
        raise ValueError(f"quantize_pack: bits must be 1..8, got {bits}")


@_lib.counted(NAME, lambda a, bits: 0.0)   # elementwise: no GEMM flops
def quantize_pack(a: torch.Tensor, bits: int):
    """(M, K) float32 activations or uint8 levels -> ``(levels uint8 (M,
    K), planes int32 (bits, M, ceil(K/32)))``, planes packed LSB first
    along K with the bit patterns of the reference's uint32 words.  On
    the device: one ``torch.empty`` an output and one launch; any
    contiguous input is taken, at any offset into its storage."""
    _check(a, bits)
    if a.device.type in _lib.PLAIN_DEVICES:
        return quantize_pack_plain(a, bits)
    if a.device.type != "cuda":
        raise ValueError(f"quantize_pack: unsupported device {a.device}")
    m, k = a.shape
    levels_in = a.dtype == torch.uint8
    lv = a if levels_in else torch.empty((m, k), dtype=torch.uint8,
                                         device=a.device)
    planes = torch.empty((bits, m, -(-k // bitplane.LANE)), dtype=torch.int32,
                         device=a.device)
    if planes.numel() == 0:
        return lv, planes
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _lib.launcher(NAME, [p, p, p, i, i, i, i, p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = launch(a.data_ptr(), None if levels_in else lv.data_ptr(),
                     planes.data_ptr(), m, k, int(levels_in), bits, stream)
    _lib.check_launch(NAME, err)
    _lib.LAUNCHES[NAME] += 1
    return lv, planes

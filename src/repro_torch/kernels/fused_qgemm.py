"""Fused quantize -> level GEMM -> rowsum -> dequant (the serve GEMM).

Port of ``repro/kernels/fused_qgemm.py`` (``fused_qgemm_pallas``).  The
CUDA kernel is ``csrc/fused_qgemm.cu``; its source note says what bounds it
on an H100 and how it is laid out: u8 tensor-core ``mma`` on a ``cp.async``
ring, and split-K over a thread-block cluster for skinny M (the plan is
the ``.cu`` file's ``plan_for``, exported as ``fused_qgemm_plan``;
:func:`gemm_plan` is its CPU-side copy).  :func:`fused_qgemm` is the wrapper: a
CPU tensor takes :func:`fused_qgemm_plain`, a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.and_accum import (dequant_epilogue, epilogue_scales,
                                        int32_exact, level_gemm_exact)
from repro_torch.core.quant import activation_levels
from . import _lib

NAME = "fused_qgemm"

# csrc/fused_qgemm.cu's plan constants: BN output columns a block, NST
# stages of the cp.async ring; only 16-row tiles (M <= 32) split K, by
# _lib.split_steps
BN, NST = 64, 4


class GemmPlan(NamedTuple):
    bm: int       # rows a block
    bk: int       # K bytes a pipeline stage
    nsplit: int   # K splits: one thread-block cluster a tile
    steps: int    # K steps a split
    smem: int     # dynamic shared memory a block


def gemm_plan(m: int, n: int, k: int) -> GemmPlan:
    """The launch plan ``csrc/fused_qgemm.cu`` makes for (M, N, K): its
    ``plan_for``, copied here so the CPU can read it (the card's tests
    hold the two equal through :func:`kernel_plan`)."""
    bm = 16 if m <= 32 else 64
    bk = 128 if bm == 16 else 64
    tiles = max(1, -(-m // bm) * -(-n // BN))
    nsteps = max(1, -(-k // bk))
    steps = _lib.split_steps(tiles, nsteps, bm == 16, split_wide=False)
    return GemmPlan(bm, bk, -(-nsteps // steps), steps,
                    NST * (bm * bk + bk * BN))


def kernel_plan(m: int, n: int, k: int) -> GemmPlan:
    """The plan the built kernel's ``fused_qgemm_plan`` returns (needs
    ``nvcc``: the card's tests)."""
    plan = (ctypes.c_int * 5)()
    i = ctypes.c_int
    fn = _lib.launcher(NAME, [i, i, i, ctypes.POINTER(ctypes.c_int)], "plan")
    _lib.check_launch(NAME, fn(m, n, k, plan))
    return GemmPlan(*plan)


def fused_qgemm_plain(a: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                      a_bits: int, w_bits: int,
                      a_is_levels: bool = False) -> torch.Tensor:
    """Plain PyTorch version: exact (float64) accumulator and rowsum, then
    the shared f32 epilogue."""
    lv = a if a_is_levels else activation_levels(a, a_bits)[0]
    acc = level_gemm_exact(lv, w_lv)
    rowsum = lv.to(torch.float64).sum(dim=1)
    s, t = epilogue_scales(a_bits, s_w, z_w)
    return dequant_epilogue(acc, rowsum, s, t)


def _check(a: torch.Tensor, w_lv: torch.Tensor, a_bits: int, w_bits: int,
           a_is_levels: bool) -> None:
    if a.ndim != 2 or w_lv.ndim != 2 or a.shape[1] != w_lv.shape[0]:
        raise ValueError(f"fused_qgemm: shapes {tuple(a.shape)} x "
                         f"{tuple(w_lv.shape)} do not form (M,K) x (K,N)")
    want = torch.uint8 if a_is_levels else torch.float32
    if a.dtype != want or w_lv.dtype != torch.uint8:
        raise TypeError(f"fused_qgemm: needs a {want} and w_lv uint8, got "
                        f"{a.dtype} and {w_lv.dtype}")
    if a.device != w_lv.device:
        raise ValueError(f"fused_qgemm: a on {a.device}, w_lv on "
                         f"{w_lv.device}")
    if not (a.is_contiguous() and w_lv.is_contiguous()):
        raise ValueError("fused_qgemm: operands must be contiguous")
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"fused_qgemm: bit widths must be 1..8, got "
                         f"a={a_bits} w={w_bits}")
    if not int32_exact(a.shape[1], a_bits, w_bits):
        raise ValueError(f"fused_qgemm: int32 accumulator may overflow at "
                         f"K={a.shape[1]}, a_bits={a_bits}, w_bits={w_bits}")


def _launcher():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _lib.launcher(NAME, [p, p, p, i, i, i, i, i, f, f, p])


@_lib.counted(NAME, _lib.gemm_flops)
def fused_qgemm(a: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                a_bits: int, w_bits: int,
                a_is_levels: bool = False) -> torch.Tensor:
    """(M, K) float activations or uint8 levels x (K, N) uint8 weight
    levels -> (M, N) float32 ``s*acc - t*rowsum``."""
    _check(a, w_lv, a_bits, w_bits, a_is_levels)
    if a.device.type in _lib.PLAIN_DEVICES:
        return fused_qgemm_plain(a, w_lv, s_w, z_w, a_bits=a_bits,
                                 w_bits=w_bits, a_is_levels=a_is_levels)
    if a.device.type != "cuda":
        raise ValueError(f"fused_qgemm: unsupported device {a.device}")
    (m, k), n = a.shape, w_lv.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    s, t = epilogue_scales(a_bits, s_w, z_w)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _launcher()(a.data_ptr(), w_lv.data_ptr(), out.data_ptr(),
                          m, n, k, int(a_is_levels), a_bits, float(s),
                          float(t), stream)
    _lib.check_launch(NAME, err)
    _lib.LAUNCHES[NAME] += 1
    return out

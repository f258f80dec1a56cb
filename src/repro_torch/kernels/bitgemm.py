"""Packed AND + popcount bit-GEMM, the paper's Eq. (1) computed literally.

Port of ``repro/kernels/bitgemm.py`` (``bitgemm_packed_pallas``).  The CUDA
kernel is ``csrc/bitgemm.cu``; its source note says what bounds it on an
H100 and how it is laid out: ``mma`` on the binary tensor cores
(``.b1 .and.popc``) fed straight from the packed planes, and split-K over a
thread-block cluster for skinny M (the plan is the ``.cu`` file's
``plan_for``, exported as ``bitgemm_packed_plan``; :func:`packed_plan` is
its CPU-side copy).  :func:`bitgemm_packed` is the wrapper: a CPU tensor
takes :func:`bitgemm_packed_plain`, a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.and_accum import bitgemm_packed_planes, int32_exact
from repro_torch.core.bitplane import LANE
from . import _lib

NAME = "bitgemm_packed"

# csrc/bitgemm.cu's plan constants: BN output columns a block (16 rows at
# M <= 32, 64 for one plane pair where those tiles fill the SMs twice
# over, else 32), KW_STEP words of K a stage (ROW bytes a staged plane
# row), at most MAX_NST stages in SMEM_MAX bytes of shared memory; K is
# split by _lib.split_steps, counted in stages
BN, KW_STEP, MAX_NST, SMEM_MAX = 64, 16, 4, 232448
ROW, RED_PITCH = 4 * KW_STEP, BN + 4


class PackedPlan(NamedTuple):
    bm: int       # rows a block
    nst: int      # stages of the cp.async ring
    nsplit: int   # K splits: one thread-block cluster a tile
    steps: int    # stages a split
    smem: int     # dynamic shared memory a block


def packed_plan(m: int, n: int, kw: int, a_bits: int,
                w_bits: int) -> PackedPlan:
    """The launch plan ``csrc/bitgemm.cu`` makes for (M, N, Kw) words at
    the given widths: its ``plan_for``, copied here so the CPU can read it
    (the card's tests hold the two equal through :func:`kernel_plan`)."""
    tiles64 = -(-m // 64) * -(-n // BN)
    bm = (16 if m <= 32 else
          64 if a_bits * w_bits == 1 and tiles64 >= 2 * _lib.SMS else 32)
    stage = (a_bits * bm + w_bits * BN) * ROW
    nst = min(MAX_NST, SMEM_MAX // stage)
    tiles = max(1, -(-m // bm) * -(-n // BN))
    nsteps = max(1, -(-kw // KW_STEP))
    steps = _lib.split_steps(tiles, nsteps, bm == 16)
    nsplit = -(-nsteps // steps)
    return PackedPlan(bm, nst, nsplit, steps,
                      max(nst * stage, bm * RED_PITCH * 4 if nsplit > 1
                          else 0))


def kernel_plan(m: int, n: int, kw: int, a_bits: int,
                w_bits: int) -> PackedPlan:
    """The plan the built kernel's ``bitgemm_packed_plan`` returns (needs
    ``nvcc``: the card's tests)."""
    plan = (ctypes.c_int * 5)()
    i = ctypes.c_int
    fn = _lib.launcher(NAME, [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)],
                       "plan")
    _lib.check_launch(NAME, fn(m, n, kw, a_bits, w_bits, plan))
    return PackedPlan(*plan)


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


def _bit_flops(a_planes, w_planes, *, a_bits: int, w_bits: int) -> float:
    """2·M·N·K bit operations for each of the a_bits·w_bits plane pairs."""
    _, m, kw = _lib.local_shape(a_planes)
    n = _lib.local_shape(w_planes)[1]
    return 2.0 * m * n * LANE * kw * a_bits * w_bits


@_lib.counted(NAME, _bit_flops)
def bitgemm_packed(a_planes: torch.Tensor, w_planes: torch.Tensor, *,
                   a_bits: int, w_bits: int) -> torch.Tensor:
    """(a_bits, M, Kw) and (w_bits, N, Kw) int32 words -> (M, N) int32
    ``sum_mn 2^(m+n) popcount(A_m & W_n)``."""
    _check(a_planes, w_planes, a_bits, w_bits)
    if a_planes.device.type in _lib.PLAIN_DEVICES:
        return bitgemm_packed_plain(a_planes, w_planes, a_bits=a_bits,
                                    w_bits=w_bits)
    if a_planes.device.type != "cuda":
        raise ValueError(f"bitgemm_packed: unsupported device "
                         f"{a_planes.device}")
    _, m, kw = a_planes.shape
    n = w_planes.shape[1]
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

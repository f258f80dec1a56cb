"""Tiled s8 x s8 -> s32 matmul, the int8 engines' product.

Port of ``repro/kernels/bitgemm_mxu.py`` (``int8_matmul_pallas``), the
kernel the reference's MXU mapping runs on the nibble groups of the levels
(``ops.bitgemm_mxu``).  The CUDA kernel is ``csrc/int8_matmul.cu``; its
source note says what bounds it on an H100 and how it is laid out: s8
tensor-core ``mma`` on a ``cp.async`` ring, and split-K over a
thread-block cluster (the plan is the ``.cu`` file's ``plan_for``,
exported as ``int8_matmul_plan``; :func:`matmul_plan` is its CPU-side
copy).  :func:`int8_matmul` is the wrapper: a CPU tensor takes
:func:`int8_matmul_plain`, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.and_accum import level_gemm_exact
from . import _lib

NAME = "int8_matmul"

# csrc/int8_matmul.cu's plan constants: BN output columns a block, NST
# stages of the cp.async ring; K is split by _lib.split_steps
BN, NST = 64, 4


class MatmulPlan(NamedTuple):
    bm: int       # rows a block
    bk: int       # K bytes a pipeline stage
    nsplit: int   # K splits: one thread-block cluster a tile
    steps: int    # K steps a split
    smem: int     # dynamic shared memory a block


def matmul_plan(m: int, n: int, k: int) -> MatmulPlan:
    """The launch plan ``csrc/int8_matmul.cu`` makes for (M, N, K): its
    ``plan_for``, copied here so the CPU can read it (the card's tests
    hold the two equal through :func:`kernel_plan`)."""
    bm = 16 if m <= 32 else 64
    bk = 128 if bm == 16 else 64
    tiles = max(1, -(-m // bm) * -(-n // BN))
    nsteps = max(1, -(-k // bk))
    steps = _lib.split_steps(tiles, nsteps, bm == 16)
    return MatmulPlan(bm, bk, -(-nsteps // steps), steps,
                      NST * (bm * bk + bk * BN))


def kernel_plan(m: int, n: int, k: int) -> MatmulPlan:
    """The plan the built kernel's ``int8_matmul_plan`` returns (needs
    ``nvcc``: the card's tests)."""
    plan = (ctypes.c_int * 5)()
    i = ctypes.c_int
    fn = _lib.launcher(NAME, [i, i, i, ctypes.POINTER(ctypes.c_int)], "plan")
    _lib.check_launch(NAME, fn(m, n, k, plan))
    return MatmulPlan(*plan)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the exact (float64) product as int32."""
    return level_gemm_exact(a, b).to(torch.int32)


def int8_exact(k: int) -> bool:
    """No int32 partial sum of K products of s8 operands can overflow:
    ``128 * 128 * K < 2^31``."""
    return 128 * 128 * max(k, 1) < (1 << 31)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not form (M,K) x (K,N)")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul: needs int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"int8_matmul: a on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("int8_matmul: operands must be contiguous")
    if not int8_exact(a.shape[1]):
        raise ValueError(f"int8_matmul: int32 accumulator may overflow at "
                         f"K={a.shape[1]}")


@_lib.counted(NAME, _lib.gemm_flops)
def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, any shape and any base
    alignment (the kernel stages rows cp.async cannot take through its
    masked path)."""
    _check(a, b)
    if a.device.type in _lib.PLAIN_DEVICES:
        return int8_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _lib.launcher(NAME, [p, p, p, i, i, i, p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     stream)
    _lib.check_launch(NAME, err)
    _lib.LAUNCHES[NAME] += 1
    return out

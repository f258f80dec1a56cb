"""Implicit-GEMM quantized conv: the level conv without an im2col tensor.

Port of ``repro/kernels/conv_implicit.py`` (``conv_implicit_pallas``).  The
CUDA kernel is ``csrc/conv_implicit.cu``; its source note says what bounds
it on an H100 and how it works: u8 tensor-core ``mma`` fed by
``ldmatrix`` straight from each block's staged halo'd row span, the
weights streamed through a ``cp.async`` ring.  :func:`conv_implicit` is
the wrapper: a CPU tensor takes :func:`conv_implicit_plain`, a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.and_accum import (dequant_epilogue, epilogue_scales,
                                        int32_exact, level_gemm_exact)
from repro_torch.core.conv_lowering import _out_hw, im2col_sliced, pad_split
from . import _lib

NAME = "conv_implicit"

# block tile of csrc/conv_implicit.cu: TM output pixels (the largest of
# TMS that gives the grid a block a SM) x TN channels; the weights stream
# through NST stages of CH 16-channel chunks (CH * 16 K rows x TN bytes)
TMS, TN, CH, NST = (128, 64, 32, 16), 64, 8, 4
# shared memory one block may use on an H100 (227 KB), and its SM count
SMEM_LIMIT = 232448
SMS = 132


class ConvLayout(NamedTuple):
    """One launch's tile and shared memory (``csrc/conv_implicit.cu``)."""
    tm: int           # output pixels a block
    cpitch: int       # bytes a staged pixel: Cin in 16-byte chunks, odd
    xs_bytes: int     # the staged row span
    smem_bytes: int   # span, weight ring, chunk tables, zero chunk, rowsums


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def smem_layout(h: int, w: int, cin: int, kh: int, kw: int, stride: int,
                padding: str, batch: int, cout: int) -> ConvLayout:
    """The launch layout of one call: the largest pixel tile of TMS whose
    grid has at least SMS blocks and whose block fits SMEM_LIMIT (else the
    smallest tile).  A call is feasible iff the 16-pixel tile fits, at any
    batch and Cout.  The plan's feasibility bound (``api/targets.py``) and
    the wrapper both call this function; the kernel refuses a shared
    memory size other than its own sum for the layout."""
    oh, ow = _out_hw(h, w, kh, kw, stride, padding)
    cpt = -(-cin // 16)
    cpitch = 16 * (cpt if cpt % 2 else cpt + 1)
    nqp = -(-kh * kw * cpt // CH) * CH     # K chunks, whole stages
    fixed = NST * CH * 16 * TN + 12 * nqp + 16
    for tm in TMS:
        rows_out = min(oh, 1 + (ow - 1 + tm - 1) // ow)
        span = ((rows_out - 1) * stride + kh) * ((ow - 1) * stride + kw)
        xs = _r16(span * cpitch)
        layout = ConvLayout(tm, cpitch, xs, xs + fixed + 4 * tm)
        blocks = batch * -(-oh * ow // tm) * -(-cout // TN)
        if layout.smem_bytes <= SMEM_LIMIT and blocks >= SMS:
            return layout
    return layout


def conv_implicit_plain(x_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                        kh: int, kw: int, stride: int = 1,
                        padding: str = "SAME", a_bits: int,
                        w_bits: int) -> torch.Tensor:
    """Plain PyTorch version: im2col patches of the levels, exact (float64)
    accumulator and rowsum, the shared f32 epilogue; NHWC f32 out."""
    b, h, w, cin = x_lv.shape
    oh, ow = _out_hw(h, w, kh, kw, stride, padding)
    patches = im2col_sliced(x_lv, kh, kw, stride, padding)
    patches = patches.reshape(-1, kh * kw * cin)
    acc = level_gemm_exact(patches, w_lv)
    rowsum = patches.to(torch.float64).sum(dim=1)
    s, t = epilogue_scales(a_bits, s_w, z_w)
    return dequant_epilogue(acc, rowsum, s, t).reshape(b, oh, ow, -1)


def _check(x_lv, w_lv, kh, kw, stride, padding, a_bits, w_bits) -> None:
    if x_lv.ndim != 4 or w_lv.ndim != 2:
        raise ValueError(f"conv_implicit: needs x (B,H,W,Cin) and w "
                         f"(kh*kw*Cin, Cout), got {tuple(x_lv.shape)}, "
                         f"{tuple(w_lv.shape)}")
    k = kh * kw * x_lv.shape[3]
    if w_lv.shape[0] != k:
        raise ValueError(f"conv_implicit: w has {w_lv.shape[0]} rows, "
                         f"kh*kw*Cin = {k}")
    if x_lv.dtype != torch.uint8 or w_lv.dtype != torch.uint8:
        raise TypeError(f"conv_implicit: needs uint8 levels, got "
                        f"{x_lv.dtype} and {w_lv.dtype}")
    if x_lv.device != w_lv.device:
        raise ValueError(f"conv_implicit: x on {x_lv.device}, w on "
                         f"{w_lv.device}")
    if not (x_lv.is_contiguous() and w_lv.is_contiguous()):
        raise ValueError("conv_implicit: operands must be contiguous")
    if padding not in ("SAME", "VALID") or stride < 1:
        raise ValueError(f"conv_implicit: stride {stride} / padding "
                         f"{padding!r} unsupported")
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"conv_implicit: bit widths must be 1..8, got "
                         f"a={a_bits} w={w_bits}")
    if not int32_exact(k, a_bits, w_bits):
        raise ValueError(f"conv_implicit: int32 accumulator may overflow "
                         f"at K={k}, a_bits={a_bits}, w_bits={w_bits}")


def _launcher():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _lib.launcher(NAME, [p, p, p] + [i] * 16 + [f, f, p])


def _conv_flops(x_lv, w_lv, s_w, z_w, *, kh: int, kw: int, stride: int = 1,
                padding: str = "SAME", **_) -> float:
    """2·M·N·K of the conv's GEMM view: M = B·OH·OW, K = kh·kw·Cin."""
    b, h, w, _ = _lib.local_shape(x_lv)
    oh, ow = _out_hw(h, w, kh, kw, stride, padding)
    k, cout = _lib.local_shape(w_lv)
    return 2.0 * b * oh * ow * cout * k


@_lib.counted(NAME, _conv_flops)
def conv_implicit(x_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                  kh: int, kw: int, stride: int = 1, padding: str = "SAME",
                  a_bits: int, w_bits: int) -> torch.Tensor:
    """(B,H,W,Cin) uint8 levels (*) (kh*kw*Cin, Cout) uint8 weight levels
    -> (B,OH,OW,Cout) float32 ``s*acc - t*rowsum``."""
    _check(x_lv, w_lv, kh, kw, stride, padding, a_bits, w_bits)
    if x_lv.device.type in _lib.PLAIN_DEVICES:
        return conv_implicit_plain(x_lv, w_lv, s_w, z_w, kh=kh, kw=kw,
                                   stride=stride, padding=padding,
                                   a_bits=a_bits, w_bits=w_bits)
    if x_lv.device.type != "cuda":
        raise ValueError(f"conv_implicit: unsupported device {x_lv.device}")
    b, h, w, cin = x_lv.shape
    cout = w_lv.shape[1]
    oh, ow = _out_hw(h, w, kh, kw, stride, padding)
    (pt, _), (pl, _) = pad_split(h, w, kh, kw, stride, padding)
    lay = smem_layout(h, w, cin, kh, kw, stride, padding, b, cout)
    if lay.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"conv_implicit: a block needs {lay.smem_bytes} B "
                         f"of shared memory (> {SMEM_LIMIT})")
    out = torch.empty((b, oh, ow, cout), dtype=torch.float32,
                      device=x_lv.device)
    if out.numel() == 0:
        return out
    s, t = epilogue_scales(a_bits, s_w, z_w)
    with torch.cuda.device(x_lv.device):
        stream = torch.cuda.current_stream(x_lv.device).cuda_stream
        err = _launcher()(x_lv.data_ptr(), w_lv.data_ptr(), out.data_ptr(),
                          b, h, w, cin, cout, kh, kw, stride, oh, ow, pt, pl,
                          *lay, float(s), float(t), stream)
    _lib.check_launch(NAME, err)
    _lib.LAUNCHES[NAME] += 1
    return out

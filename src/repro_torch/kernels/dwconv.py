"""Depthwise 3x3 quantized conv: each channel's levels against its own
nine weight levels, the ``depthwise`` engine.

No Pallas kernel: the JAX package has no grouped convolution.  The CUDA
kernel is ``csrc/dwconv.cu``; its source note says what bounds it on an
H100 (bytes) and how it works.  :func:`dwconv` is the wrapper: a CPU or
meta tensor takes :func:`dwconv_plain`, a CUDA tensor launches the kernel
or raises.  Each launch counts its stride in
``launch.trace.TRACER.counters`` (``kernels.dwconv.s1`` /
``kernels.dwconv.s2``).  :func:`bounds` states what the kernel takes; the
plan's feasibility check (``ops.engine_feasible``) and so the prover use
it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.and_accum import epilogue_scales
from repro_torch.core.conv_lowering import _out_hw, pad_split
from repro_torch.launch.trace import TRACER
from . import _lib

NAME = "dwconv"
# the kernel's side, strides and channel vector (csrc/dwconv.cu)
KSIZE = 3
STRIDES = (1, 2)
CHANNEL_VEC = 4


def bounds(kh: int, kw: int, stride: int, padding: str,
           channels: int) -> tuple[bool, str]:
    """Does the kernel take this depthwise conv?  ``(ok, reason)``."""
    if (kh, kw) != (KSIZE, KSIZE):
        return False, f"dwconv takes 3x3 kernels, not {kh}x{kw}"
    if stride not in STRIDES:
        return False, f"dwconv takes stride 1 or 2, not {stride}"
    if padding != "SAME":
        return False, f"dwconv takes SAME padding, not {padding!r}"
    if channels < 1 or channels % CHANNEL_VEC:
        return False, (f"dwconv takes channels in whole 4-byte vectors, "
                       f"not {channels}")
    return True, ""


def scales(a_bits: int, s_w, z_w) -> tuple[np.float32, int]:
    """``(s_half, z2)``: half the epilogue's scale (exact) and twice the
    weights' zero point, which must be an integer."""
    s, _ = epilogue_scales(a_bits, s_w, z_w)
    z2 = 2.0 * float(z_w)
    if z2 != int(z2):
        raise ValueError(f"dwconv: 2 * z_w = {z2} is not an integer")
    return np.float32(s) * np.float32(0.5), int(z2)


def dwconv_plain(x_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                 stride: int = 1, a_bits: int, w_bits: int) -> torch.Tensor:
    """Plain PyTorch version: the nine taps of each channel as shifted
    slices of the zero-padded levels, summed in int32 against
    ``2 w - z2`` (exact), then the float of that sum times ``s_half``;
    NHWC float32 out."""
    b, h, w, c = x_lv.shape
    oh, ow = _out_hw(h, w, KSIZE, KSIZE, stride, "SAME")
    (pt, pb), (pl, pr) = pad_split(h, w, KSIZE, KSIZE, stride, "SAME")
    xp = torch.nn.functional.pad(x_lv.to(torch.int32), (0, 0, pl, pr, pt, pb))
    s_half, z2 = scales(a_bits, s_w, z_w)
    w2 = 2 * w_lv.to(torch.int32) - z2
    acc = torch.zeros((b, oh, ow, c), dtype=torch.int32, device=x_lv.device)
    for dy in range(KSIZE):
        for dx in range(KSIZE):
            acc += xp[:, dy:dy + (oh - 1) * stride + 1:stride,
                      dx:dx + (ow - 1) * stride + 1:stride] * w2[dy * KSIZE
                                                                 + dx]
    return acc.to(torch.float32) * float(s_half)


def _check(x_lv, w_lv, stride, a_bits, w_bits) -> None:
    if x_lv.ndim != 4 or w_lv.ndim != 2:
        raise ValueError(f"dwconv: needs x (B,H,W,C) and w (9, C), got "
                         f"{tuple(x_lv.shape)}, {tuple(w_lv.shape)}")
    c = x_lv.shape[3]
    if tuple(w_lv.shape) != (KSIZE * KSIZE, c):
        raise ValueError(f"dwconv: w is {tuple(w_lv.shape)}, needs "
                         f"({KSIZE * KSIZE}, {c})")
    if x_lv.dtype != torch.uint8 or w_lv.dtype != torch.uint8:
        raise TypeError(f"dwconv: needs uint8 levels, got {x_lv.dtype} and "
                        f"{w_lv.dtype}")
    if x_lv.device != w_lv.device:
        raise ValueError(f"dwconv: x on {x_lv.device}, w on {w_lv.device}")
    if not (x_lv.is_contiguous() and w_lv.is_contiguous()):
        raise ValueError("dwconv: operands must be contiguous")
    ok, reason = bounds(KSIZE, KSIZE, stride, "SAME", c)
    if not ok:
        raise ValueError(reason)
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"dwconv: bit widths must be 1..8, got a={a_bits} "
                         f"w={w_bits}")


def _dw_flops(x_lv, w_lv, s_w, z_w, *, stride: int = 1, **_) -> float:
    """2 multiply-adds' operations a tap of each output: 2·9·B·OH·OW·C."""
    b, h, w, c = _lib.local_shape(x_lv)
    oh, ow = _out_hw(h, w, KSIZE, KSIZE, stride, "SAME")
    return 2.0 * KSIZE * KSIZE * b * oh * ow * c


@_lib.counted(NAME, _dw_flops)
def dwconv(x_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
           stride: int = 1, a_bits: int, w_bits: int) -> torch.Tensor:
    """(B,H,W,C) uint8 levels, (9, C) uint8 weight levels -> (B,OH,OW,C)
    float32, SAME padding at ``stride``: :func:`dwconv_plain`'s numbers."""
    _check(x_lv, w_lv, stride, a_bits, w_bits)
    if x_lv.device.type in _lib.PLAIN_DEVICES:
        return dwconv_plain(x_lv, w_lv, s_w, z_w, stride=stride,
                            a_bits=a_bits, w_bits=w_bits)
    if x_lv.device.type != "cuda":
        raise ValueError(f"dwconv: unsupported device {x_lv.device}")
    b, h, w, c = x_lv.shape
    oh, ow = _out_hw(h, w, KSIZE, KSIZE, stride, "SAME")
    (pt, _), (pl, _) = pad_split(h, w, KSIZE, KSIZE, stride, "SAME")
    if x_lv.data_ptr() % 4 or w_lv.data_ptr() % 4:
        raise ValueError("dwconv: x and w must start on a 4-byte boundary")
    out = torch.empty((b, oh, ow, c), dtype=torch.float32,
                      device=x_lv.device)
    if out.numel() == 0:
        return out
    s_half, z2 = scales(a_bits, s_w, z_w)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch = _lib.launcher(NAME, [p, p, p] + [i] * 10 + [f, p])
    with torch.cuda.device(x_lv.device):
        stream = torch.cuda.current_stream(x_lv.device).cuda_stream
        err = launch(x_lv.data_ptr(), w_lv.data_ptr(), out.data_ptr(), b, h,
                     w, c, stride, oh, ow, pt, pl, z2, float(s_half), stream)
    _lib.check_launch(NAME, err)
    _lib.LAUNCHES[NAME] += 1
    TRACER.count(f"kernels.dwconv.s{stride}")
    return out

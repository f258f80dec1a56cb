"""Lower 2-D convolution onto the level GEMM (port of
``repro/core/conv_lowering.py``).

All layouts are NHWC activations and HWIO float weights, as in the
reference.  ``F.conv2d(padding="same")`` refuses stride > 1 and splits
padding differently from lax's SAME, so every conv here pads explicitly
through :func:`pad_split`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .prequant import level_dtype
from .quant import activation_levels


def _out_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: str):
    if padding == "SAME":
        return -(-h // stride), -(-w // stride)
    return (h - kh) // stride + 1, (w - kw) // stride + 1


def pad_split(h: int, w: int, kh: int, kw: int, stride: int, padding: str):
    """((top, bottom), (left, right)) zero-pad — the SAME split, single
    source for every conv lowering and both conv kernels."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    oh, ow = _out_hw(h, w, kh, kw, stride, padding)
    ph = max((oh - 1) * stride + kh - h, 0)
    pw = max((ow - 1) * stride + kw - w, 0)
    return (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def _pad_nhwc(x: torch.Tensor, pads) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    if pt == pb == pl == pr == 0:
        return x
    # F.pad pads trailing dims first: (C), (W), (H)
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def im2col_sliced(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                  padding: str = "SAME") -> torch.Tensor:
    """Dtype-agnostic im2col by strided slices: (B,H,W,C) -> (B,OH,OW,
    kh*kw*C), feature layout (kh, kw, C)-major."""
    b, h, w, c = x.shape
    oh, ow = _out_hw(h, w, kh, kw, stride, padding)
    if padding == "SAME":
        x = _pad_nhwc(x, pad_split(h, w, kh, kw, stride, padding))
    cols = [x[:, dy: dy + (oh - 1) * stride + 1: stride,
              dx: dx + (ow - 1) * stride + 1: stride, :]
            for dy in range(kh) for dx in range(kw)]
    return torch.cat(cols, dim=-1)


def quant_conv2d_pre(x: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                     kh: int, kw: int, stride: int = 1,
                     padding: str = "SAME", a_bits: int = 4,
                     w_bits: int = 1, engine: str, w_planes=None,
                     reference: bool = False) -> torch.Tensor:
    """Serve conv on pre-quantized weights: quantize the (B,H,W,C) image to
    levels once, then run the level conv through ``engine``.  ``w_planes``:
    the weights packed for the faithful engine.  ``reference=True`` runs
    the kernels' plain versions instead (see
    :func:`repro_torch.kernels.ops.quant_conv_serve`)."""
    from repro_torch.kernels import ops  # kernels layer sits above core

    # contiguous levels, as the kernels take their operands (the input a
    # full-window FC layer gets from resize_linear is strided)
    x_lv = activation_levels(x, a_bits)[0].to(level_dtype(a_bits))
    return ops.quant_conv_serve(x_lv.contiguous(), w_lv, s_w, z_w, kh=kh,
                                kw=kw, stride=stride, padding=padding,
                                a_bits=a_bits, w_bits=w_bits, engine=engine,
                                w_planes=w_planes, reference=reference)


def conv2d_float(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """fp conv (the fp first/last layers): NHWC x, HWIO w -> NHWC.  Runs in
    full fp32 (TF32 is switched off in ``repro_torch/__init__.py``)."""
    kh, kw = w.shape[0], w.shape[1]
    x = _pad_nhwc(x, pad_split(x.shape[1], x.shape[2], kh, kw, stride,
                               padding))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()

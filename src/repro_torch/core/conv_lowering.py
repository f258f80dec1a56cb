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
from .quant import activation_levels, weight_levels


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


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x (B,H,W,C) -> patches (B,OH,OW,C*kh*kw), features (C, kh, kw)-major
    as the reference's ``lax.conv_general_dilated_patches`` emits them (a
    reordering of :func:`im2col_sliced`, so exact in any dtype)."""
    b, _, _, c = x.shape
    p = im2col_sliced(x, kh, kw, stride, padding)
    oh, ow = p.shape[1], p.shape[2]
    return p.reshape(b, oh, ow, kh * kw, c).transpose(3, 4).reshape(
        b, oh, ow, c * kh * kw)


def quant_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME", a_bits: int = 4, w_bits: int = 1,
                 engine: str | None = None) -> torch.Tensor:
    """Bit-wise conv on float weights, requantized on every call (the
    reference's training-checkpoint entry point): x (B,H,W,Cin) in [0,1],
    w (kh,kw,Cin,Cout) float -> (B,OH,OW,Cout).  ``fused`` and
    ``faithful`` run the serve kernels on the levels
    (:func:`repro_torch.kernels.ops.quant_dense_serve`); the other level
    engines the float-in dense.  ``engine=None`` asks
    :func:`repro_torch.kernels.ops.select_engine`."""
    from repro_torch.kernels import ops  # kernels layer sits above core
    from .and_accum import quant_dense_forward

    kh, kw, cin, cout = w.shape
    patches = im2col(x, kh, kw, stride, padding)
    b, oh, ow, kdim = patches.shape
    # im2col's features are (C, kh, kw)-major: the weights follow
    w2 = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    if engine is None:
        engine = ops.select_engine(b * oh * ow, kdim, cout, a_bits, w_bits,
                                   device=x.device)
    if engine in ("fused", "faithful"):
        w_lv, s_w, z_w = weight_levels(w2, w_bits)
        p_lv = activation_levels(patches.reshape(-1, kdim), a_bits)[0]
        out = ops.quant_dense_serve(
            p_lv.to(level_dtype(a_bits)).contiguous(),
            w_lv.to(level_dtype(w_bits)).contiguous(), float(s_w),
            float(z_w), a_bits=a_bits, w_bits=w_bits,
            engine=engine).to(x.dtype)
    else:
        out = quant_dense_forward(patches.reshape(-1, kdim), w2, a_bits,
                                  w_bits, engine=engine)
    return out.reshape(b, oh, ow, cout)


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


class ConvGemmWeightGrad(torch.autograd.Function):
    """``F.conv2d`` (NCHW x, OIHW w, no padding) whose weight gradient is
    one fp32 GEMM over the im2col patches.  cuDNN's deterministic
    weight-gradient algorithms, which the bit-identical trainers need,
    lose 1.4e-3 x max|g| on the svhn CNN's 5x5 first layer against a
    float64 gradient (``train_precision.py``: H100, cuDNN 9.2); the GEMM
    keeps every layer within 1.5e-6, as the CPU.  The input gradient is
    cuDNN's."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, gy,
                                            stride=ctx.stride)
        if ctx.needs_input_grad[1]:
            cout, b = w.shape[0], x.shape[0]
            cols = F.unfold(x, w.shape[2:], stride=ctx.stride)  # (B, K, L)
            gw = (gy.reshape(b, cout, -1).permute(1, 0, 2).reshape(cout, -1)
                  @ cols.permute(0, 2, 1).reshape(-1, cols.shape[1]))
            gw = gw.reshape(w.shape)
        return gx, gw, None


def conv2d_float(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """fp conv (the fp first/last layers, and every training conv): NHWC
    x, HWIO w -> NHWC.  Runs in full fp32 (TF32 is switched off in
    ``repro_torch/__init__.py``); under autograd the weight gradient is
    :class:`ConvGemmWeightGrad`'s GEMM."""
    kh, kw = w.shape[0], w.shape[1]
    x = _pad_nhwc(x, pad_split(x.shape[1], x.shape[2], kh, kw, stride,
                               padding))
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = ConvGemmWeightGrad.apply(xc, wc, stride)
    else:
        y = F.conv2d(xc, wc, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()

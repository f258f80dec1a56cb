"""Plain PyTorch reference of the paper's bit-wise SVHN CNN as served
(arXiv:1904.07864, Sec. III-A; DoReFa quantizers).

The network: a 5x5 float conv, five 3x3 convs and two 1x1 convs (the
fully connected layers), an average pool after the third and fifth layers,
a float 1x1 output layer, and the mean over the last map as the logits.
Every layer but the last is followed by the serving norm (per-sample
statistics over the map, population variance, eps 1e-5, then scale and
shift), a clip to [0, 1] and the k-bit activation quantizer
``round(x * (2^a - 1)) / (2^a - 1)`` (round half to even).  The first and
last layers take float weights; the others DoReFa weights: at 1 bit
``alpha * sign(w)`` with ``alpha = mean|w|`` (sign(0) = +1), at k bits
``2 * round(t * (2^k - 1)) / (2^k - 1) - 1`` with
``t = tanh(w) / (2 max|tanh(w)|) + 0.5``.

Arithmetic: float32 with TF32 off, as the configuration states, except the
quantized convolutions, which sum integer activation levels against the
weight levels in float64 (exact) and scale once.  The 2x2 pool is the
window's sum in row-major order divided by 4, as the model defines it:
pooled 4-bit activations land on exact halves of a level, so the order of
that sum decides where round-half-to-even sends them.

``tf32=True`` is the control: the float convolutions take their operands
rounded to TF32 (10 explicit mantissa bits, round to nearest even), which
is what the tensor cores do when TF32 is allowed.  This module imports
nothing of the program.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Layer:
    """One conv layer of a network description, as the benchmark's shape
    arithmetic (``chipbench.yardstick``) reads it: SAME padding at
    ``stride`` unless the kernel is 1x1 or ``fc`` (VALID; an ``fc`` layer
    takes its input resized to k x k and gives 1 x 1)."""
    cin: int
    cout: int
    k: int
    pool: bool = False
    role: str = "mid"          # first | mid | last
    stride: int = 1
    fc: bool = False


def network(cfg: dict) -> list[Layer]:
    """The layer list at the configuration's width ``channels``."""
    c, cin, classes = cfg["channels"], cfg["in_channels"], cfg["classes"]
    return [
        Layer(cin, c, 5, role="first"),
        Layer(c, c, 3),
        Layer(c, 2 * c, 3, pool=True),
        Layer(2 * c, 2 * c, 3),
        Layer(2 * c, 4 * c, 3, pool=True),
        Layer(4 * c, 4 * c, 3),
        Layer(4 * c, 8 * c, 1),
        Layer(8 * c, classes, 1, role="last"),
    ]


def is_float_layer(layer: Layer, cfg: dict) -> bool:
    return cfg["first_last_fp"] and layer.role in ("first", "last")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest
    even (kept in float32)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def weight_levels(w: torch.Tensor, bits: int):
    """DoReFa weights as ``scale * (levels - zero)``: (levels float64,
    scale, zero) with scale and zero float32 values as Python floats."""
    w = w.double()
    if bits == 1:
        alpha = float(torch.abs(w).mean().float())
        return (w >= 0).double(), 2.0 * alpha, 0.5
    n = (1 << bits) - 1
    t = torch.tanh(w.float())
    t = t / (2.0 * torch.abs(t).max() + 1e-12) + 0.5
    return torch.round(t * n).clamp(0, n).double(), 2.0 / n, n / 2.0


def act_levels(x: torch.Tensor, bits: int) -> torch.Tensor:
    n = (1 << bits) - 1
    return torch.round(torch.clamp(x, 0.0, 1.0) * n)


def _norm_clip(y: torch.Tensor, g, beta) -> torch.Tensor:
    mu = y.mean(dim=(2, 3), keepdim=True)
    var = ((y - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 1e-5) * g[None, :, None, None]
    return torch.clamp(y + beta[None, :, None, None], 0.0, 1.0)


def layer_step(p: dict, layer: Layer, h: torch.Tensor, cfg: dict, *,
               last: bool, tf32: bool = False) -> torch.Tensor:
    """One layer on NCHW float32 ``h``: the conv, the bias, then (unless
    ``last``) the norm, the clip and the activation quantizer.  The layer's
    pool is not applied here (:func:`pool`)."""
    if layer.stride != 1 or layer.fc:
        raise ValueError(f"{layer}: this reference serves stride-1 convs")
    a_bits, w_bits = cfg["a_bits"], cfg["w_bits"]
    n_a = (1 << a_bits) - 1
    pad = layer.k // 2
    w = p["w"].permute(3, 2, 0, 1).contiguous()           # OIHW
    if is_float_layer(layer, cfg):
        if tf32:
            h, w = tf32_round(h), tf32_round(w)
        y = F.conv2d(h, w, padding=pad)
    else:
        lv, scale, zero = weight_levels(w, w_bits)
        acc = F.conv2d(act_levels(h, a_bits).double(), lv - zero, padding=pad)
        y = (acc * (scale / n_a)).float()
    y = y + p["b"][None, :, None, None]
    if last:
        return y
    return act_levels(_norm_clip(y, p["g"], p["beta"]), a_bits) / n_a


def pool(h: torch.Tensor) -> torch.Tensor:
    """The 2x2 average pool on NCHW: the window's sum in row-major order,
    then / 4."""
    hh, ww = (h.shape[2] // 2) * 2, (h.shape[3] // 2) * 2
    h = h[:, :, :hh, :ww]
    s = (h[:, :, 0::2, 0::2] + h[:, :, 0::2, 1::2]) + h[:, :, 1::2, 0::2]
    return (s + h[:, :, 1::2, 1::2]) / 4.0


def states(params: list[dict], x: torch.Tensor, cfg: dict, *,
           tf32: bool = False) -> tuple[list[torch.Tensor], torch.Tensor]:
    """x (B, H, W, C) float32 in [0, 1] -> (each hidden layer's output before
    its pool, NHWC; the logits (B, classes)).  ``params``: one dict a
    layer, ``w`` (k, k, cin, cout) float32, ``b``, ``g`` and ``beta``
    (cout,)."""
    layers = network(cfg)
    h = x.permute(0, 3, 1, 2).contiguous()
    out = []
    for i, (layer, p) in enumerate(zip(layers, params)):
        last = i == len(layers) - 1
        y = layer_step(p, layer, h, cfg, last=last, tf32=tf32)
        if not last:
            out.append(y.permute(0, 2, 3, 1))
        h = pool(y) if layer.pool else y
    return out, h.mean(dim=(2, 3))


def forward(params: list[dict], x: torch.Tensor, cfg: dict, *,
            tf32: bool = False) -> torch.Tensor:
    """x (B, H, W, C) float32 in [0, 1] -> logits (B, classes) float32."""
    return states(params, x, cfg, tf32=tf32)[1]


@contextlib.contextmanager
def no_tf32():
    """Float32 products and convolutions stay float32 (TF32 off), and no
    autograd, for the duration."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved

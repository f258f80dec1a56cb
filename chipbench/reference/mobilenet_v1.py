"""Plain PyTorch reference of MobileNet-v1 as the port serves it
(Howard et al., "MobileNets: Efficient Convolutional Neural Networks for
Mobile Vision Applications", arXiv:1704.04861, Table 1, as TF-slim's
``mobilenet_v1.py`` builds it; DoReFa quantizers).

The network at width multiplier ``width`` (``max(int(d * width), 8)``
channels, TF-slim's ``depth_multiplier``): a 3x3 stride-2 conv stem, 13
depthwise-separable blocks, each a 3x3 depthwise conv (one group a
channel) at the block's stride and a 1x1 pointwise conv, and a 1x1
classifier; the logits are the mean over the last map.  Convolutions pad
SAME as TensorFlow does (a stride-2 3x3 conv on an even side pads 0
before and 1 after); 1x1 convs take no padding.

Departures from the paper, each as the port serves the network:

* W1A4: 1-bit DoReFa weights and 4-bit activations on every layer but
  the stem and the classifier, which stay float (the paper under
  reproduction, arXiv:1904.07864, keeps first and last layers float).
* The serving norm in place of batch norm: per-sample statistics over
  the map (population variance, eps 1e-5), then scale and shift, after
  every layer but the last.
* A clip to [0, 1] and the k-bit activation quantizer
  ``round(x * (2^a - 1)) / (2^a - 1)`` (round half to even) in place of
  ReLU6.
* The classifier before the mean: a 1x1 conv over the 7x7 map, then the
  mean, where the paper pools and then applies the fully connected
  layer.  The two are equal up to float rounding; this order costs 49x
  the classifier's multiply-accumulates.

The quantized weights: at 1 bit ``alpha * sign(w)`` with ``alpha =
mean|w|`` over the layer (sign(0) = +1), at k bits ``2 * round(t * (2^k -
1)) / (2^k - 1) - 1`` with ``t = tanh(w) / (2 max|tanh(w)|) + 0.5``.

Arithmetic: float32 with TF32 off, except the quantized convolutions,
which sum integer activation levels against the weight levels in float64
(exact; depthwise layers as ``F.conv2d(..., groups=C)``) and scale once.

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

# TF-slim's _CONV_DEFS after the stem: (pointwise channels, depthwise stride)
BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
          (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
          (1024, 1))


@dataclasses.dataclass(frozen=True)
class Layer:
    """One conv layer: ``cin`` input channels a group (1 for a depthwise
    layer, whose ``groups`` is ``cout``), SAME padding at ``stride``
    unless the kernel is 1x1 (VALID)."""
    cin: int
    cout: int
    k: int
    pool: bool = False
    role: str = "mid"          # first | mid | last
    stride: int = 1
    fc: bool = False
    groups: int = 1


def network(cfg: dict) -> list[Layer]:
    """The 28 layers at the configuration's ``width``, ``in_channels`` and
    ``classes``."""
    width = cfg["width"]

    def d(c: int) -> int:
        return max(int(c * width), 8)

    layers = [Layer(cfg["in_channels"], d(32), 3, role="first", stride=2)]
    cin = d(32)
    for cout, stride in BLOCKS:
        layers += [Layer(1, cin, 3, stride=stride, groups=cin),
                   Layer(cin, d(cout), 1)]
        cin = d(cout)
    layers.append(Layer(cin, cfg["classes"], 1, role="last"))
    return layers


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


def same_pad(h: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """NCHW ``h`` zero-padded as TensorFlow's SAME: the total
    ``(ceil(side / stride) - 1) * stride + k - side`` split with the
    smaller half first."""
    pads = []
    for side in (h.shape[3], h.shape[2]):         # F.pad: W first, then H
        out = -(-side // stride)
        total = max((out - 1) * stride + k - side, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(h, pads)


def _norm_clip(y: torch.Tensor, g, beta) -> torch.Tensor:
    mu = y.mean(dim=(2, 3), keepdim=True)
    var = ((y - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 1e-5) * g[None, :, None, None]
    return torch.clamp(y + beta[None, :, None, None], 0.0, 1.0)


def layer_step(p: dict, layer: Layer, h: torch.Tensor, cfg: dict, *,
               last: bool, tf32: bool = False) -> torch.Tensor:
    """One layer on NCHW float32 ``h``: the conv, the bias, then (unless
    ``last``) the norm, the clip and the activation quantizer.
    ``p["w"]`` is HWIO (k, k, cin, cout)."""
    if layer.fc or layer.pool:
        raise ValueError(f"{layer}: MobileNet-v1 has no fc resize or pool")
    a_bits, w_bits = cfg["a_bits"], cfg["w_bits"]
    n_a = (1 << a_bits) - 1
    if layer.k > 1:
        h = same_pad(h, layer.k, layer.stride)
    w = p["w"].permute(3, 2, 0, 1).contiguous()           # OIHW
    if is_float_layer(layer, cfg):
        if tf32:
            h, w = tf32_round(h), tf32_round(w)
        y = F.conv2d(h, w, stride=layer.stride, groups=layer.groups)
    else:
        lv, scale, zero = weight_levels(w, w_bits)
        acc = F.conv2d(act_levels(h, a_bits).double(), lv - zero,
                       stride=layer.stride, groups=layer.groups)
        y = (acc * (scale / n_a)).float()
    y = y + p["b"][None, :, None, None]
    if last:
        return y
    return act_levels(_norm_clip(y, p["g"], p["beta"]), a_bits) / n_a


def states(params: list[dict], x: torch.Tensor, cfg: dict, *,
           tf32: bool = False) -> tuple[list[torch.Tensor], torch.Tensor]:
    """x (B, H, W, C) float32 in [0, 1] -> (each hidden layer's output,
    NHWC; the logits (B, classes)).  ``params``: one dict a layer, ``w``
    (k, k, cin, cout) float32, ``b``, ``g`` and ``beta`` (cout,)."""
    layers = network(cfg)
    h = x.permute(0, 3, 1, 2).contiguous()
    out = []
    for i, (layer, p) in enumerate(zip(layers, params)):
        last = i == len(layers) - 1
        h = layer_step(p, layer, h, cfg, last=last, tf32=tf32)
        if not last:
            out.append(h.permute(0, 2, 3, 1))
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

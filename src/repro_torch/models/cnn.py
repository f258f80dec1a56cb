"""The paper's CNN models (port of ``repro/models/cnn.py``).

* ``svhn_cnn`` — 6 conv + 2 average-pool + 2 FC layers (FCs as 1x1
  convolutions), for 40x40 SVHN digits; first and last layers stay full
  precision.
* ``alexnet`` — binary-weight AlexNet for the ImageNet rows.
* ``mobilenet_v1`` — MobileNet-v1 (Howard et al., arXiv:1704.04861,
  Table 1, as TF-slim's ``mobilenet_v1.py`` builds it): 13
  depthwise-separable blocks, each a 3x3 depthwise conv (``groups ==
  cout``, served by the ``depthwise`` engine) and a 1x1 pointwise conv.

This module holds the specs, the seeded initializer, the per-layer
pieces the plan executor applies between convolutions, the forward and
the loss, and the spec walk of the paper's storage model
(:func:`count_params`, :func:`count_acts`, :func:`count_macs`).
:func:`cnn_forward` in ``mode="serve"`` runs the cached per-call plan of
:func:`repro_torch.core.plan.cnn_serve_layers` on float or prequantized
params: on the card its quantized layers launch the Hopper kernels.  Any
other mode is the training forward (the DoReFa fake-quant conv on
straight-through weights, batch statistics in the norm, optional k-bit
gradient quantization), which launches no port kernel: its convolutions
are float (``conv2d_float``), as the reference's are.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.conv_lowering import conv2d_float
from repro_torch.core.prequant import is_fp_layer
from repro_torch.core.quant import (QuantConfig, quantize_gradient,
                                    quantize_weight)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    cin: int
    cout: int
    k: int = 3
    stride: int = 1
    pool: bool = False   # 2x2 average pool after this layer
    role: str = "mid"    # first | mid | last
    fc: bool = False     # fully-connected: VALID conv reducing to 1x1
    # 1, or cout for a depthwise conv; ``cin`` is the input channels a
    # group (the HWIO weight's I axis), so a depthwise layer has cin 1
    groups: int = 1


def svhn_cnn_spec(channels: int = 64) -> list[ConvSpec]:
    """6 conv + 2 pool + 2 FC(=1x1 conv) — the paper's SVHN model."""
    c = channels
    return [
        ConvSpec(3, c, 5, role="first"),
        ConvSpec(c, c, 3),
        ConvSpec(c, 2 * c, 3, pool=True),
        ConvSpec(2 * c, 2 * c, 3),
        ConvSpec(2 * c, 4 * c, 3, pool=True),
        ConvSpec(4 * c, 4 * c, 3),
        ConvSpec(4 * c, 8 * c, 1),
        ConvSpec(8 * c, 10, 1, role="last"),
    ]


def alexnet_spec() -> list[ConvSpec]:
    """AlexNet conv/FC stack (FCs as convs) for the ImageNet rows."""
    return [
        ConvSpec(3, 96, 11, stride=4, pool=True, role="first"),
        ConvSpec(96, 256, 5, pool=True),
        ConvSpec(256, 384, 3),
        ConvSpec(384, 384, 3),
        ConvSpec(384, 256, 3, pool=True),
        ConvSpec(256, 4096, 6, fc=True),
        ConvSpec(4096, 4096, 1, fc=True),
        ConvSpec(4096, 1000, 1, fc=True, role="last"),
    ]


# TF-slim's _CONV_DEFS after the stem: (pointwise cout, depthwise stride)
MOBILENET_V1_BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                       (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                       (512, 1), (1024, 2), (1024, 1))


def mobilenet_v1_spec(width: float = 1.0,
                      classes: int = 1000) -> list[ConvSpec]:
    """MobileNet-v1 at width multiplier ``width`` (the paper's alpha,
    TF-slim's ``depth_multiplier``: ``max(int(d * width), 8)`` channels):
    the float 3x3 stride-2 stem, 13 (depthwise 3x3, pointwise 1x1) pairs,
    and the float classifier as a 1x1 conv over the last 7x7 map.  The
    forward's closing mean makes that the average pool and the fully
    connected layer in the other order (equal up to float rounding; 49x
    the classifier's multiply-accumulates).  28 layers."""
    def d(c: int) -> int:
        return max(int(c * width), 8)

    spec = [ConvSpec(3, d(32), 3, stride=2, role="first")]
    cin = d(32)
    for cout, stride in MOBILENET_V1_BLOCKS:
        spec += [ConvSpec(1, cin, 3, stride=stride, groups=cin),
                 ConvSpec(cin, d(cout), 1)]
        cin = d(cout)
    spec.append(ConvSpec(cin, classes, 1, role="last"))
    return spec


def init_cnn(generator: torch.Generator, spec: Sequence[ConvSpec],
             dtype=torch.float32) -> list[dict]:
    """Random float params on ``generator``'s device: HWIO ``w`` drawn
    N(0, 1/fan_in), zero bias, unit norm scale, zero norm shift.  (The
    reference draws from a JAX PRNG; tests carry its params across with
    :mod:`repro_torch.convert` instead of re-drawing.)"""
    dev = generator.device
    params = []
    for s in spec:
        fan_in = s.k * s.k * s.cin
        w = torch.randn((s.k, s.k, s.cin, s.cout), generator=generator,
                        dtype=dtype, device=dev) / math.sqrt(fan_in)
        params.append(dict(
            w=w, b=torch.zeros(s.cout, dtype=dtype, device=dev),
            g=torch.ones(s.cout, dtype=dtype, device=dev),
            beta=torch.zeros(s.cout, dtype=dtype, device=dev)))
    return params


def _norm_act(x: torch.Tensor, g, beta, quant: QuantConfig, role: str,
              mode: str = "serve", *, bias=None,
              reference: bool = False) -> torch.Tensor:
    """Per-channel norm + bounded activation (clip to [0,1], then the
    DoReFa activation quantizer), of ``x + bias`` where a ``bias`` is
    given.  Serve mode takes PER-SAMPLE (spatial-only) statistics, so a
    request's output never depends on its batchmates, in one launch of
    :func:`repro_torch.kernels.norm_act.norm_act` on a CUDA ``x`` (its
    plain version with ``reference``); train mode takes batch statistics
    over (B, H, W) in PyTorch ops.  ``jnp.var`` is the population variance
    (correction=0)."""
    from repro_torch.kernels.norm_act import norm_act, norm_act_plain

    bits = 32 if (role == "last" or quant.engine == "fp") else quant.a_bits
    if mode != "serve":
        return norm_act_plain(x, g, beta, bias, bits, dims=(0, 1, 2))
    return (norm_act_plain if reference else norm_act)(x, g, beta, bias, bits)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID average pool on NHWC: the window sum, then / 4
    (the reference's ``reduce_window`` add / 4.0)."""
    h, w = (x.shape[1] // 2) * 2, (x.shape[2] // 2) * 2
    x = x[:, :h, :w]
    s = (x[:, 0::2, 0::2] + x[:, 0::2, 1::2]) + x[:, 1::2, 0::2]
    return (s + x[:, 1::2, 1::2]) / 4.0


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of ``jax.image.resize(..., "linear")``
    along one axis: a triangle kernel, widened by in/out when downsampling
    (antialiasing), columns normalized — the same float32 arithmetic as
    ``jax.image.scale.compute_weight_mat`` with zero translation."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    weights = np.maximum(f32(0), f32(1) - x / kernel_scale)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    eps = f32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int,
                    device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_matrix(in_size, out_size)).to(device)


def resize_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC spatial resize to (size, size), antialiased linear, as an
    explicit interpolation matrix per axis (built once per size and
    device)."""
    mh = _resize_weights(x.shape[1], size, x.device)
    mw = _resize_weights(x.shape[2], size, x.device)
    return torch.einsum("bhwc,hi,wj->bijc", x, mh, mw)


def cnn_forward(params, x: torch.Tensor, spec: Sequence[ConvSpec],
                quant: QuantConfig, mode: str = "train",
                g_gen: torch.Generator | None = None) -> torch.Tensor:
    """x (B,H,W,3) in [0,1] -> logits (B, classes).

    ``mode="serve"`` runs the per-call plan of
    :func:`repro_torch.core.plan.cnn_serve_layers` for this (spec, quant,
    batch, image size), cached, on ``x``'s device: the cuda target's
    engines (an explicit ``quant.engine`` taken unchecked), per-sample
    norm statistics, float ``params`` prequantized at the call.  On a
    CUDA ``x`` the quantized layers launch the Hopper kernels; a compiled
    plan (``api.build(...).compile()``) gives the same logits.

    Any other mode is the training forward.  Each layer: the float conv
    (fp layers) or the fake-quant conv on :func:`quantize_weight`'s
    straight-through weights (the input is already quantized by the
    previous norm-act); with ``g_gen``, the k-bit gradient quantizer after
    every non-fp layer (its noise drawn from ``g_gen``, layer after layer,
    where the reference folds the layer index into its key); bias; the
    train-mode norm-act on all but the last layer; the 2x2 average pool;
    an FC layer over a larger map first resizes it to k x k; finally the
    global mean."""
    if mode == "serve":
        from repro_torch.core.plan import cnn_serve_layers, execute_cnn_layers

        layers = cnn_serve_layers(spec, quant, batch=x.shape[0],
                                  img_hw=(x.shape[1], x.shape[2]))
        return execute_cnn_layers(layers, params, x, quant)
    h = x
    for i, (p, s) in enumerate(zip(params, spec)):
        h = cnn_layer(p, s, h, quant, i == len(spec) - 1, g_gen)
    return torch.mean(h, dim=(1, 2))


def conv_bias(p, s: ConvSpec, h: torch.Tensor, quant: QuantConfig,
              g_gen: torch.Generator | None = None) -> torch.Tensor:
    """A training layer up to its norm: the FC resize, the conv (fake-quant
    weights unless an fp layer), the gradient quantizer with ``g_gen``,
    the bias.  A depthwise layer is refused, naming it: training has no
    grouped convolution (a depthwise layer is served only)."""
    if s.groups != 1:
        raise ValueError(f"{s}: the training forward has no grouped "
                         f"convolution; a depthwise layer is served only")
    pad = "VALID" if (s.fc or s.k == 1) else "SAME"
    if s.fc and s.k > 1 and h.shape[1] != s.k:
        h = resize_linear(h, s.k)
    fp_layer = is_fp_layer(s, quant)
    w = p["w"] if fp_layer else quantize_weight(p["w"], quant.w_bits)
    h = conv2d_float(h, w, stride=s.stride, padding=pad)
    if g_gen is not None and not fp_layer:
        h = quantize_gradient(h, quant.g_bits, g_gen)
    return h + p["b"]


def cnn_layer(p, s: ConvSpec, h: torch.Tensor, quant: QuantConfig,
              last: bool, g_gen: torch.Generator | None = None
              ) -> torch.Tensor:
    """One layer of :func:`cnn_forward`: :func:`conv_bias`, the train-mode
    norm-act unless ``last``, the pool."""
    h = conv_bias(p, s, h, quant, g_gen)
    if not last:
        h = _norm_act(h, p["g"], p["beta"], quant, s.role, "train")
    if s.pool:
        h = avg_pool2(h)
    return h


def xent(logits: torch.Tensor, labels: torch.Tensor):
    """Mean softmax cross-entropy and accuracy of ``logits`` (B, classes)
    against integer ``labels`` (B,) -> ``(loss, {"loss", "acc"})``."""
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, dict(loss=loss, acc=acc)


def cnn_loss(params, batch: dict, spec: Sequence[ConvSpec],
             quant: QuantConfig, g_gen: torch.Generator | None = None):
    """Softmax cross-entropy of the training forward on ``batch``
    (``image`` (B,H,W,3), ``label`` (B,) int) -> ``(loss, {"loss",
    "acc"})``."""
    return xent(cnn_forward(params, batch["image"], spec, quant, "train",
                            g_gen), batch["label"])


def count_params(spec: Sequence[ConvSpec]) -> int:
    return sum(s.k * s.k * s.cin * s.cout for s in spec)


def count_acts(spec: Sequence[ConvSpec], img: int) -> int:
    """Peak activation element count for the storage model (Fig. 8)."""
    h = img
    total = img * img * 3
    for s in spec:
        h = max(h // s.stride, 1)
        total += h * h * s.cout
        if s.pool:
            h //= 2
    return total


def count_macs(spec: Sequence[ConvSpec], img: int) -> int:
    """MAC count per image (the paper's '80 FLOPs' ~ 80 MFLOPs on 40x40)."""
    h = img
    total = 0
    for s in spec:
        oh = 1 if s.fc else max(-(-h // s.stride), 1)
        total += oh * oh * s.k * s.k * s.cin * s.cout
        h = oh
        if s.pool:
            h = max(h // 2, 1)
    return total

"""What the benchmark hands to both sides, made from ``--seed`` on the
device: the float parameters of every layer and the pool of images that
the traffic draws from.  Both come from one ``torch.Generator`` on the
device, in one call each, so set-up does not draw leaf by leaf.

Weights are N(0, 1/fan_in) in HWIO; biases N(0, 0.1^2); norm scales
1 + N(0, 0.1^2) and shifts N(0, 0.1^2), so that every term of the serving
layer is exercised.  Images are uniform in [0, 1].
"""
from __future__ import annotations

import math

import torch

SEED_MOD = 1 << 63


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    return gen


def draw_params(layers, gen: torch.Generator) -> list[dict]:
    """One dict a layer (``w`` (k, k, cin, cout), ``b``, ``g``, ``beta``),
    float32, on the generator's device, from one draw."""
    sizes = [(l.k * l.k * l.cin * l.cout, l.cout) for l in layers]
    total = sum(nw + 3 * nc for nw, nc in sizes)
    flat = torch.randn(total, generator=gen, device=gen.device,
                       dtype=torch.float32)
    params, at = [], 0
    for l, (nw, nc) in zip(layers, sizes):
        w = flat[at:at + nw].view(l.k, l.k, l.cin, l.cout)
        b, g, beta = flat[at + nw:at + nw + 3 * nc].view(3, nc)
        at += nw + 3 * nc
        params.append(dict(w=(w / math.sqrt(l.k * l.k * l.cin)).contiguous(),
                           b=(0.1 * b).contiguous(),
                           g=(1.0 + 0.1 * g).contiguous(),
                           beta=(0.1 * beta).contiguous()))
    return params


def draw_pool(n: int, img_hw: int, channels: int,
              gen: torch.Generator) -> torch.Tensor:
    """``n`` distinct images (n, H, W, C) float32 in [0, 1] on the device."""
    return torch.rand((n, img_hw, img_hw, channels), generator=gen,
                      device=gen.device, dtype=torch.float32)

"""Serve-time weight pre-quantization (port of ``repro/core/prequant.py``).

Conv/FC weights are quantized once, at plan compile, into unsigned levels
plus per-layer ``(s_w, z_w)``.  Levels up to 8 bits are stored as
``torch.uint8``: Hopper's integer dot products take unsigned 8-bit
operands, so the reference's nibble split of 8-bit operands (which exists
only because the TPU's MXU takes signed int8) is not needed.  The scales
are kept as Python floats holding float32 values, so no kernel launch ever
waits on a device-to-host read of a scale.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .quant import QuantConfig, weight_levels


def level_dtype(bits: int) -> torch.dtype:
    """Narrowest dtype holding unsigned ``bits``-wide levels."""
    return torch.uint8 if bits <= 8 else torch.int32


def prequantize_conv_weight(w: torch.Tensor, w_bits: int):
    """(kh, kw, cin, cout) float -> ((kh*kw*cin, cout) levels, s_w, z_w).

    The flattened axis is (kh, kw, cin)-major — the layout
    :func:`repro_torch.core.conv_lowering.im2col_sliced` emits."""
    lv, s_w, z_w = weight_levels(w, w_bits)
    lv = lv.reshape(-1, w.shape[-1]).to(level_dtype(w_bits)).contiguous()
    return lv, float(s_w), float(z_w)


def is_fp_layer(spec_entry, quant: QuantConfig) -> bool:
    return quant.engine == "fp" or quant.w_bits >= 32 or (
        spec_entry.role in ("first", "last") and quant.first_last_fp)


def prequantize_cnn_params(params, spec: Sequence, quant: QuantConfig):
    """Quantized layers swap the float ``w`` for ``{w_lv, s_w, z_w}``
    (bias/norm params unchanged); fp layers pass through."""
    out = []
    for p, s in zip(params, spec):
        if is_fp_layer(s, quant):
            out.append(dict(p))
            continue
        w_lv, s_w, z_w = prequantize_conv_weight(p["w"], quant.w_bits)
        q = {k: v for k, v in p.items() if k != "w"}
        q.update(w_lv=w_lv, s_w=s_w, z_w=z_w)
        out.append(q)
    return out


def is_prequantized(params) -> bool:
    return any(isinstance(p, dict) and "w_lv" in p for p in params)


def serve_weight_bytes(params) -> int:
    """Weight bytes the serve path reads per forward: each layer's
    ``w_lv`` as stored, else its float ``w`` (derived ``w_planes`` are not
    counted).  Levels are stored as :func:`level_dtype` gives them, one
    byte up to 8 bits, where the reference keeps 8-bit levels as int32:
    the two counts agree up to 7-bit weights and differ at 8 bits."""
    total = 0
    for p in params:
        w = p.get("w_lv", p.get("w"))
        if w is not None:
            total += w.numel() * w.element_size()
    return total

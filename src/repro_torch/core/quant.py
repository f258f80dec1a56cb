"""DoReFa low-bitwidth quantizers (port of ``repro/core/quant.py``).

The bit-width config, the integer-level views consumed by the level GEMM
(unsigned for the CNN, affine-signed for transformer activations), the
float activation quantizer applied after each hidden CNN layer, and the
fake-quant (train-mode) forms the LM's float-weight projections take:
:func:`quantize_weight` and :func:`fake_quant_act_signed`, whose forward
value is the reference's straight-through ``x + (q - x)``, computed as
written (it is not always ``q`` in float32).  There is no backward
pass: the port serves.  ``torch.round`` rounds half to
even, exactly as ``jnp.round`` does; the CUDA kernels use ``rintf`` (the
same rounding), never ``roundf``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Bit-width configuration, e.g. the paper's W:I = 1:4 with 8-bit grads.

    ``engine``: 'auto' (the compute target's dispatch), 'fp' (no bitwise
    engine), or an explicit engine name pinning every quantized layer:
    'fused', 'implicit', 'faithful' (the paper's AND + popcount on
    packed bit planes), 'int8', 'int8_planewise', 'planes', 'packed' or
    'f32dot'.  All give the same int32 accumulator and the same epilogue,
    so their outputs are equal bit for bit.

    ``act_scale_mode`` is the dynamic activation-scale granularity on the
    signed (LM) serve path: 'tensor' (one absmax over the dispatched batch)
    or 'row' (one absmax per GEMM row, so a row's levels do not depend on
    its batchmates — the continuous-batching engine forces it).
    """

    w_bits: int = 1
    a_bits: int = 4
    g_bits: int = 8
    first_last_fp: bool = True
    engine: str = "auto"
    act_scale_mode: str = "tensor"

    def tag(self) -> str:
        return f"w{self.w_bits}a{self.a_bits}g{self.g_bits}"


FP32 = QuantConfig(w_bits=32, a_bits=32, g_bits=32, engine="fp")
W1A1 = QuantConfig(1, 1, 8)
W1A4 = QuantConfig(1, 4, 8)
W1A8 = QuantConfig(1, 8, 8)
W2A2 = QuantConfig(2, 2, 8)
PAPER_CONFIGS = {"w32a32": FP32, "w1a1": W1A1, "w1a4": W1A4, "w1a8": W1A8,
                 "w2a2": W2A2}


def quantize_k(x: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa quantize_k: x in [0,1] -> k-bit levels in [0,1] (float)."""
    n = (1 << bits) - 1
    return torch.round(x * n) / n


def quantize_activation(a: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa activation quantizer: clip to [0,1] then k-bit."""
    if bits >= 32:
        return a
    return quantize_k(torch.clamp(a, 0.0, 1.0), bits)


def activation_levels(a: torch.Tensor, bits: int):
    """Integer-level view: a_q = levels / (2^bits - 1).  Returns
    ``(levels int32, scale)``."""
    n = (1 << bits) - 1
    levels = torch.clamp(torch.round(torch.clamp(a, 0.0, 1.0) * n), 0, n)
    return levels.to(torch.int32), 1.0 / n


def weight_levels(w: torch.Tensor, bits: int):
    """Integer-level view of the quantized weight: w_q = scale*(levels - zp).

    Returns ``(levels int32, scale, zero_point)`` with the scalars as 0-d
    float32 tensors on ``w``'s device.  The 1-bit scale ``2*mean|w|`` is
    accumulated in float64 and rounded once, so it is the correctly rounded
    value whatever order the device sums in.
    """
    n = (1 << bits) - 1
    if bits == 1:
        alpha = torch.mean(torch.abs(w), dtype=torch.float64).to(w.dtype)
        levels = (w >= 0).to(torch.int32)
        return levels, 2.0 * alpha, torch.tensor(0.5, dtype=w.dtype,
                                                 device=w.device)
    t = torch.tanh(w)
    t = t / (2.0 * torch.max(torch.abs(t)) + 1e-12) + 0.5
    levels = torch.clamp(torch.round(t * n), 0, n).to(torch.int32)
    return (levels, torch.tensor(2.0 / n, dtype=w.dtype, device=w.device),
            torch.tensor(n / 2.0, dtype=w.dtype, device=w.device))


def signed_levels(a: torch.Tensor, s: torch.Tensor, bits: int
                  ) -> torch.Tensor:
    """``clip(round(a / s) + z, 0, 2^b - 1)`` in ``a``'s dtype, each op
    rounded to that dtype as XLA rounds it (a bfloat16 quotient rounds to
    bfloat16 before ``round``), then int32; ``z = 2^(b-1)``."""
    n = (1 << bits) - 1
    z = float(1 << (bits - 1))
    return torch.clamp(torch.round(a / s) + z, 0, n).to(torch.int32)


def activation_levels_signed(a: torch.Tensor, bits: int):
    """Affine (signed) integer-level view for transformer activations:
    ``a_q = s * (levels - z)`` with ``z = 2^(b-1)`` and a per-tensor absmax
    scale ``s = max|a| / z + 1e-12``, computed in ``a``'s dtype.

    Returns ``(levels int32, s 0-d in a's dtype, z 0-d in a's dtype)``."""
    z = float(1 << (bits - 1))
    s = torch.max(torch.abs(a)) / z + 1e-12
    return (signed_levels(a, s, bits), s,
            torch.tensor(z, dtype=a.dtype, device=a.device))


def activation_levels_signed_row(a: torch.Tensor, bits: int):
    """Per-row variant of :func:`activation_levels_signed`: ``a`` is
    (M, K) and the scale is a per-row absmax of shape (M, 1), so row m's
    levels depend on row m alone."""
    z = float(1 << (bits - 1))
    s = torch.amax(torch.abs(a), dim=-1, keepdim=True) / z + 1e-12
    return (signed_levels(a, s, bits), s,
            torch.tensor(z, dtype=a.dtype, device=a.device))


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The forward value of the reference's straight-through estimator,
    ``x + stop_gradient(q - x)``: two float roundings, as XLA computes
    it."""
    return x + (q - x)


def quantize_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa weight quantizer (float output, the STE forward value).

    1-bit:  ``sign(w) * mean|w|`` (XNOR-Net style scaled binarization);
    k-bit:  ``2 * quantize_k(tanh(w) / (2 max|tanh(w)|) + 1/2) - 1``.
    ``mean|w|`` is accumulated in float64 and rounded once, as in
    :func:`weight_levels`."""
    if bits >= 32:
        return w
    if bits == 1:
        alpha = torch.mean(torch.abs(w), dtype=torch.float64).to(w.dtype)
        return _ste(w, torch.where(w >= 0, alpha, -alpha))
    t = torch.tanh(w)
    t = t / (2.0 * torch.max(torch.abs(t)) + 1e-12) + 0.5
    n = (1 << bits) - 1
    return 2.0 * _ste(t, torch.round(t * n) / n) - 1.0


def fake_quant_act_signed(a: torch.Tensor, bits: int) -> torch.Tensor:
    """The float view of :func:`activation_levels_signed` (per-tensor
    absmax), STE forward value: ``a + (q - a)`` with
    ``q = (clip(round(a / s) + z, 0, 2^b - 1) - z) * s``."""
    if bits >= 32:
        return a
    n = (1 << bits) - 1
    z = float(1 << (bits - 1))
    s = torch.max(torch.abs(a)) / z + 1e-12
    q = (torch.clamp(torch.round(a / s) + z, 0, n) - z) * s
    return _ste(a, q)

"""DoReFa low-bitwidth quantizers (port of ``repro/core/quant.py``).

The bit-width config, the integer-level views consumed by the level GEMM
(unsigned for the CNN, affine-signed for transformer activations), the
float activation quantizer applied after each hidden CNN layer, and the
fake-quant (train-mode) forms the LM's float-weight projections and the
CNN's training convolutions take: :func:`quantize_weight`,
:func:`quantize_activation` and :func:`fake_quant_act_signed`, each the
reference's straight-through estimator ``x + stop_gradient(q - x)``
(here ``x + (q - x).detach()``: its forward value computed as written,
which is not always ``q`` in float32, and its gradient the identity),
and :func:`quantize_gradient`, DoReFa's stochastic k-bit gradient
quantizer (identity forward); :func:`fake_quant_act` and
:func:`fake_quant_dense_weight` apply the first two by a config.  The
paper's closed forms: Table I's complexity (bit-plane pairs per MAC,
``QuantConfig.inference_complexity`` = w_bits * a_bits and
``training_complexity`` = that + w_bits * g_bits) and Fig. 8's storage
(:func:`model_storage_bits`).  :func:`clip01` is ``jnp.clip(x, 0, 1)``
with the reference's gradient at the bounds: ``jax.grad`` of the clip
gives 0.5 at exactly 0 and 1 (``max``/``min`` split ties), where
``torch.clamp`` gives 1.  ``torch.round`` rounds half to even, exactly
as ``jnp.round`` does; the CUDA kernels use ``rintf`` (the same
rounding), never ``roundf``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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

    @property
    def inference_complexity(self) -> int:
        """Bit-plane pairs per MAC (paper Table I)."""
        return self.w_bits * self.a_bits

    @property
    def training_complexity(self) -> int:
        """Bit-plane pairs per MAC of a training step (paper Table I)."""
        return self.w_bits * self.a_bits + self.w_bits * self.g_bits

    def tag(self) -> str:
        return f"w{self.w_bits}a{self.a_bits}g{self.g_bits}"


FP32 = QuantConfig(w_bits=32, a_bits=32, g_bits=32, engine="fp")
W1A1 = QuantConfig(1, 1, 8)
W1A4 = QuantConfig(1, 4, 8)
W1A8 = QuantConfig(1, 8, 8)
W2A2 = QuantConfig(2, 2, 8)
PAPER_CONFIGS = {"w32a32": FP32, "w1a1": W1A1, "w1a4": W1A4, "w1a8": W1A8,
                 "w2a2": W2A2}


class _Clip01(torch.autograd.Function):
    """``clamp(x, 0, 1)`` whose gradient is 1 inside, 0.5 at exactly 0 or
    1 and 0 outside — the gradient ``jax.grad`` gives ``jnp.clip``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = ((x > 0) & (x < 1)).to(g.dtype)
        edge = ((x == 0) | (x == 1)).to(g.dtype)
        return g * (inside + 0.5 * edge)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``clamp(x, 0, 1)``; under autograd with the reference's gradient at
    the bounds (:class:`_Clip01`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Clip01.apply(x)
    return torch.clamp(x, 0.0, 1.0)


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The reference's straight-through estimator ``x + stop_gradient(q -
    x)``: forward ``q`` through two float roundings, as XLA computes it;
    gradient the identity."""
    return x + (q - x).detach()


def quantize_k(x: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa quantize_k: x in [0,1] -> k-bit levels in [0,1] (STE).  For
    x in [0,1] the forward value is ``round(x n) / n`` exactly: q and x
    lie within a factor of two, so ``q - x`` and ``x + (q - x)`` are
    exact."""
    n = (1 << bits) - 1
    return _ste(x, torch.round(x * n) / n)


def quantize_activation(a: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa activation quantizer: clip to [0,1] then k-bit (STE)."""
    if bits >= 32:
        return a
    return quantize_k(clip01(a), bits)


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


def quantize_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa weight quantizer (float output, STE).

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
    return 2.0 * quantize_k(t, bits) - 1.0


def fake_quant_act_signed(a: torch.Tensor, bits: int) -> torch.Tensor:
    """The float view of :func:`activation_levels_signed` (per-tensor
    absmax, the scale taken without gradient), STE: ``a + (q - a)`` with
    ``q = (clip(round(a / s) + z, 0, 2^b - 1) - z) * s``."""
    if bits >= 32:
        return a
    n = (1 << bits) - 1
    z = float(1 << (bits - 1))
    s = torch.max(torch.abs(a)).detach() / z + 1e-12
    q = (torch.clamp(torch.round(a / s) + z, 0, n) - z) * s
    return _ste(a, q)


class _QuantizeGradient(torch.autograd.Function):
    """Identity forward; the backward quantizes the incoming gradient to
    ``bits`` (the reference's ``_qg_bwd``)."""

    @staticmethod
    def forward(ctx, x, bits, generator):
        ctx.bits, ctx.generator = bits, generator
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return quantize_gradient_values(g, ctx.bits, ctx.generator), None, None


def quantize_gradient_values(g: torch.Tensor, bits: int,
                             generator: torch.Generator | None = None
                             ) -> torch.Tensor:
    """DoReFa Eq. 12 on a gradient ``g``: scaled by ``2 max|g|`` into
    [0, 1], uniform noise of one level's width added when ``generator`` is
    given (none without: the reference's ``key=None``), rounded to
    ``2^bits - 1`` levels and scaled back, as the reference's jitted
    backward rounds it.  The noise is drawn on ``g``'s
    device from ``generator`` (which must live there), in place of the
    reference's JAX key."""
    if bits >= 32:
        return g
    n = (1 << bits) - 1
    mx = 2.0 * torch.max(torch.abs(g)) + 1e-12
    gn = g / mx + 0.5
    if generator is not None:
        u = torch.rand(g.shape, generator=generator, dtype=g.dtype,
                       device=g.device)
        gn = gn + (u - 0.5) / n
    r = torch.clamp(torch.round(gn * n), 0, n)
    # the reference's jitted backward computes q - 0.5 as one FMA,
    # fma(r, f32(1/n), -0.5); r * f32(1/n) - 0.5 is exact in float64, so
    # one rounding from float64 gives the same value
    c = float(np.float32(1.0 / n))
    q = (r.double() * c - 0.5).to(g.dtype)
    return mx * q


def quantize_gradient(x: torch.Tensor, bits: int,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """Identity forward; the backward quantizes the incoming gradient to
    ``bits`` (:func:`quantize_gradient_values`)."""
    return _QuantizeGradient.apply(x, bits, generator)


def fake_quant_dense_weight(w: torch.Tensor, cfg: QuantConfig,
                            is_first_last: bool = False) -> torch.Tensor:
    """:func:`quantize_weight` at ``cfg.w_bits`` (STE), or ``w`` itself on
    fp configs and on a first/last layer the config keeps fp."""
    if cfg.engine == "fp" or (is_first_last and cfg.first_last_fp):
        return w
    return quantize_weight(w, cfg.w_bits)


def fake_quant_act(a: torch.Tensor, cfg: QuantConfig,
                   is_first_last: bool = False) -> torch.Tensor:
    """:func:`quantize_activation` at ``cfg.a_bits`` (STE), or ``a``
    itself on fp configs and on a first/last layer the config keeps fp."""
    if cfg.engine == "fp" or (is_first_last and cfg.first_last_fp):
        return a
    return quantize_activation(a, cfg.a_bits)


def model_storage_bits(n_params: int, n_acts: int, w_bits: int,
                       a_bits: int) -> int:
    """Fig. 8 storage model: parameter bits + activation buffer bits."""
    return n_params * w_bits + n_acts * a_bits

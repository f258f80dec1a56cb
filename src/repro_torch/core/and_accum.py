"""AND-Accumulation level GEMM, the paper's Eq. (1) (port of
``repro/core/and_accum.py``):

    I * W = sum_m sum_n 2^(m+n) CMP(AND(C_n(W), C_m(I)))

Five engines, each returning the exact int32 accumulator, so all are equal
bit for bit: ``planes`` (explicit {0,1} planes, a product per plane
pair), ``packed`` (planes packed 32 per word, AND + popcount),
``int8`` (one product on the levels, nibble-split above 7 bits),
``int8_planewise`` (a product per plane pair) and ``f32dot`` (a float32
product, exact below the mantissa bound).  These are the plain PyTorch
versions: the serve path runs ``packed``'s dataflow on
``csrc/bitgemm.cu`` (the ``faithful`` engine) and the int8 products on
``csrc/int8_matmul.cu`` (:mod:`repro_torch.kernels.ops`).  Integer
products run in float64, which holds them exactly and, unlike an int64
matmul, runs on the card too.

With a = s_a * A (A unsigned levels) and w = s_w * (W - z_w):

    a @ w = s_a*s_w * (A @ W) - s_a*s_w*z_w * rowsum(A)

``dequant_epilogue`` is the single f32 epilogue expression every engine
shares; the CUDA kernels compute it with explicitly rounded multiplies
(no FMA contraction), so a kernel and its plain version agree bit for
bit.

The float-in forms quantize their operands per call, as the reference
does: :func:`quant_dense_forward` and :func:`quant_dense_forward_pre`
(unsigned activations) and :func:`quant_dense_forward_signed` (the
transformer's float weights at serve time); :func:`reference_float` is the
quantize-dequantize float product they are held to.

The signed (transformer) path, :func:`quant_dense_forward_signed_pre`, has
no Pallas kernel in the reference: its level GEMM runs in XLA on one of
four engines.  Here ``int8`` is one library int8 product,
``torch._int_mm`` on centred levels (:func:`centred_gemm_int`), exact in
int32; ``f32dot`` a float32 product of the centred levels; ``planes`` and
``packed`` Eq. (1) on the unsigned levels with the reference's 4-term
correction.  Every term of either form is exact in float32, so the four
give the same float result bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitplane
from .quant import (activation_levels, activation_levels_signed,
                    activation_levels_signed_row, signed_levels,
                    weight_levels)


def int32_exact(k: int, a_bits: int, w_bits: int) -> bool:
    """The kernels' int32 accumulator cannot overflow:
    ``(2^a - 1)(2^w - 1) K < 2^31``."""
    return ((1 << a_bits) - 1) * ((1 << w_bits) - 1) * max(k, 1) < (1 << 31)


def epilogue_scales(a_bits: int, s_w, z_w) -> tuple[np.float32, np.float32]:
    """``(s, t)`` with ``s = f32(1/(2^a-1)) * s_w`` and ``t = s * z_w``, in
    float32 — computed on the host exactly as the reference kernel's
    wrapper computes them (``fused_qgemm.py:125-127``)."""
    s_a = np.float32(1.0 / ((1 << a_bits) - 1))
    s = np.float32(s_a * np.float32(s_w))
    return s, np.float32(s * np.float32(z_w))


def level_gemm_exact(a_lv: torch.Tensor, w_lv: torch.Tensor) -> torch.Tensor:
    """Exact integer level GEMM (M,K) x (K,N) -> float64 (M,N).

    float64 holds every product and partial sum exactly (they stay below
    2^31 < 2^53), and unlike an int64 matmul it runs on the card too, so
    the same oracle serves the CPU tests and the on-card comparison."""
    return a_lv.to(torch.float64) @ w_lv.to(torch.float64)


def dequant_epilogue(acc: torch.Tensor, rowsum: torch.Tensor, s, t
                     ) -> torch.Tensor:
    """``s * f32(acc) - t * f32(rowsum)[:, None]`` in float32, each
    operation rounded on its own.  ``s`` and ``t`` are float32 values; as
    Python scalars they enter a float32 op as float32, exactly."""
    return (acc.to(torch.float32) * float(s)
            - rowsum.to(torch.float32)[:, None] * float(t))


def f32dot_exact(k: int, a_bits: int, w_bits: int) -> bool:
    """Exactness bound of :func:`bitgemm_f32dot`: every partial sum is an
    integer inside the fp32 mantissa."""
    return ((1 << a_bits) - 1) * ((1 << w_bits) - 1) * max(k, 1) < (1 << 24)


def _int_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return level_gemm_exact(a, b).to(torch.int32)


def bitgemm_planes(a_lv: torch.Tensor, w_lv: torch.Tensor, a_bits: int,
                   w_bits: int) -> torch.Tensor:
    """Eq. (1) on explicit planes: a_lv (M,K), w_lv (K,N) -> int32 (M,N).
    The AND of two {0,1} planes is their product; CMP is the sum over K."""
    pa = bitplane.decompose(a_lv, a_bits)
    pw = bitplane.decompose(w_lv, w_bits)
    out = torch.zeros((a_lv.shape[0], w_lv.shape[1]), dtype=torch.int32,
                      device=a_lv.device)
    for m in range(a_bits):
        for n in range(w_bits):
            out += _int_gemm(pa[m], pw[n]) << (m + n)
    return out


# words of one (rows, N, Kw) AND intermediate of the packed dataflow
_AND_CHUNK = 1 << 22


def bitgemm_packed_planes(a_planes: torch.Tensor, w_planes: torch.Tensor
                          ) -> torch.Tensor:
    """AND + popcount on packed planes: a_planes (a_bits, M, Kw) and
    w_planes (w_bits, N, Kw) int32 words -> int32 (M, N).  The (M, N, Kw)
    AND intermediate is taken a block of rows at a time."""
    a_bits, m, kw = a_planes.shape
    w_bits, n, _ = w_planes.shape
    out = torch.zeros((m, n), dtype=torch.int32, device=a_planes.device)
    step = max(1, _AND_CHUNK // max(n * kw, 1))
    for r0 in range(0, m, step):
        acc = out[r0:r0 + step]
        for i in range(a_bits):
            a = a_planes[i, r0:r0 + step, None, :]
            for j in range(w_bits):
                cmp = bitplane.popcount(a & w_planes[j][None]).sum(
                    dim=-1, dtype=torch.int32)
                acc += cmp << (i + j)
    return out


def bitgemm_packed(a_lv: torch.Tensor, w_lv: torch.Tensor, a_bits: int,
                   w_bits: int) -> torch.Tensor:
    """Eq. (1) on planes packed 32 per word along K: AND, popcount, shift
    by m+n, accumulate."""
    return bitgemm_packed_planes(bitplane.decompose_packed(a_lv, a_bits),
                                 bitplane.decompose_packed(w_lv.T, w_bits))


def _nibble_split(lv: torch.Tensor, bits: int):
    """Integer levels -> groups of at most 7 bits, ``lv == sum grp << sh``:
    int8 operands must stay below 128, so 8-bit levels split into two
    nibbles (two products instead of eight plane products, still exact)."""
    if bits <= 7:
        return [(lv, 0)]
    groups, shift = [], 0
    while shift < bits:
        g = min(4, bits - shift)
        groups.append(((lv >> shift) & ((1 << g) - 1), shift))
        shift += g
    return groups


def bitgemm_int8(a_lv: torch.Tensor, w_lv: torch.Tensor, a_bits: int,
                 w_bits: int) -> torch.Tensor:
    """Every plane pair folded into one int8 product on the levels
    (nibble-split above 7 bits)."""
    out = torch.zeros((a_lv.shape[0], w_lv.shape[1]), dtype=torch.int32,
                      device=a_lv.device)
    for ga, sa in _nibble_split(a_lv, a_bits):
        for gw, sw in _nibble_split(w_lv, w_bits):
            out += _int_gemm(ga.to(torch.int8), gw.to(torch.int8)) << (sa + sw)
    return out


def bitgemm_int8_planewise(a_lv: torch.Tensor, w_lv: torch.Tensor,
                           a_bits: int, w_bits: int) -> torch.Tensor:
    """Eq. (1) at plane-pair granularity, one int8 product per pair."""
    pa = bitplane.decompose(a_lv, a_bits).to(torch.int8)
    pw = bitplane.decompose(w_lv, w_bits).to(torch.int8)
    out = torch.zeros((a_lv.shape[0], w_lv.shape[1]), dtype=torch.int32,
                      device=a_lv.device)
    for m in range(a_bits):
        for n in range(w_bits):
            out += _int_gemm(pa[m], pw[n]) << (m + n)
    return out


def bitgemm_f32dot(a_lv: torch.Tensor, w_lv: torch.Tensor, a_bits: int,
                   w_bits: int) -> torch.Tensor:
    """The level GEMM as one float32 product (TF32 is off in the port):
    exact while ``a_max * w_max * K < 2^24``, and refused beyond."""
    if not f32dot_exact(a_lv.shape[-1], a_bits, w_bits):
        raise ValueError(
            f"f32dot engine inexact for a_bits={a_bits}, w_bits={w_bits}, "
            f"K={a_lv.shape[-1]} (accumulator exceeds the fp32 mantissa); "
            "use engine='int8'")
    return torch.matmul(a_lv.to(torch.float32),
                        w_lv.to(torch.float32)).to(torch.int32)


_ENGINES = {
    "planes": bitgemm_planes,
    "packed": bitgemm_packed,
    "int8": bitgemm_int8,
    "int8_planewise": bitgemm_int8_planewise,
    "f32dot": bitgemm_f32dot,
}


def bitgemm(a_lv: torch.Tensor, w_lv: torch.Tensor, a_bits: int,
            w_bits: int, engine: str = "int8") -> torch.Tensor:
    """Integer-level GEMM dispatch; every engine gives the same int32."""
    return _ENGINES[engine](a_lv, w_lv, a_bits, w_bits)


def quant_dense_pre_levels(a_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w,
                           a_bits: int, w_bits: int, engine: str = "int8"
                           ) -> torch.Tensor:
    """Unsigned dense on pre-quantized operands through one of the five
    engines: the exact accumulator, then the shared epilogue."""
    acc = bitgemm(a_lv, w_lv, a_bits, w_bits, engine)
    s, t = epilogue_scales(a_bits, s_w, z_w)
    return dequant_epilogue(acc, a_lv.sum(dim=-1, dtype=torch.int32), s, t)


def quant_dense_forward(a: torch.Tensor, w: torch.Tensor, a_bits: int,
                        w_bits: int, engine: str = "int8") -> torch.Tensor:
    """Float-in quantized dense: ``a`` (..., K) activations (clipped to
    [0, 1] by the caller's activation, as in DoReFa) and ``w`` (K, N) float
    weights, both quantized here, then the level GEMM and the shared
    epilogue; out in ``a``'s dtype."""
    w_lv, s_w, z_w = weight_levels(w, w_bits)
    return quant_dense_forward_pre(a, w_lv, float(s_w), float(z_w), a_bits,
                                   w_bits, engine)


def quant_dense_forward_pre(a: torch.Tensor, w_lv: torch.Tensor, s_w, z_w,
                            a_bits: int, w_bits: int, engine: str = "int8"
                            ) -> torch.Tensor:
    """Unsigned quantized dense with pre-quantized weights, float
    activations in: ``a`` (..., K) to levels, then
    :func:`quant_dense_pre_levels`; out in ``a``'s dtype."""
    lead = a.shape[:-1]
    a_lv, _ = activation_levels(a.reshape(-1, a.shape[-1]), a_bits)
    out = quant_dense_pre_levels(a_lv, w_lv, s_w, z_w, a_bits, w_bits,
                                 engine=engine)
    return out.reshape(lead + (w_lv.shape[-1],)).to(a.dtype)


def reference_float(a: torch.Tensor, w: torch.Tensor, a_bits: int,
                    w_bits: int) -> torch.Tensor:
    """Quantize-dequantize float matmul, the semantic oracle of the
    unsigned level GEMM."""
    a_lv, s_a = activation_levels(a.reshape(-1, a.shape[-1]), a_bits)
    w_lv, s_w, z_w = weight_levels(w, w_bits)
    aq = a_lv.to(torch.float32) * s_a
    wq = (w_lv.to(torch.float32) - z_w) * s_w
    return (aq @ wq).reshape(a.shape[:-1] + (w.shape[-1],))


# torch._int_mm on the card (cuBLASLt int8) takes more than 16 rows, a row
# count in multiples of 8, and K, N in multiples of 8
_INT_MM_MIN_ROWS = 24


def centred_gemm_int(c_lv: torch.Tensor, w_lv: torch.Tensor) -> torch.Tensor:
    """Exact int32 product (M, K) x (K, N) of centred activation levels in
    [-128, 127] and int8 weight levels: one ``torch._int_mm``, its rows
    padded with zeros as cuBLASLt needs.  On an H100 (CUDA 12.8) cuBLASLt
    served SmolLM's K in {960, 2560}, N in {320, 960, 2560} and refused
    N=96, K=64."""
    m, k = c_lv.shape
    n = w_lv.shape[1]
    if w_lv.dtype != torch.int8:
        raise ValueError(f"centred_gemm_int: needs int8 weight levels, got "
                         f"{w_lv.dtype}")
    if k % 8 or n % 8:
        raise ValueError(f"centred_gemm_int: K={k} and N={n} must be "
                         f"multiples of 8 (torch._int_mm)")
    a8 = c_lv.to(torch.int8)
    rows = max(_INT_MM_MIN_ROWS, -(-m // 8) * 8)
    if rows > m:
        a8 = torch.cat([a8, a8.new_zeros((rows - m, k))])
    return torch._int_mm(a8, w_lv)[:m]


SIGNED_ENGINES = ("planes", "packed", "int8", "f32dot")


def quant_dense_forward_signed_pre(a: torch.Tensor, w_lv: torch.Tensor, s_w,
                                   z_w, a_bits: int, w_bits: int,
                                   a_scale=None, engine: str = "int8"
                                   ) -> torch.Tensor:
    """Signed quantized dense with pre-quantized weights (the LM serve
    GEMM).  ``a`` (..., K) in the compute dtype; ``w_lv`` (K, N) int8
    levels; ``s_w``, ``z_w`` 0-d float32 tensors.

    With ``a = s_a (A - z_a)`` and ``w = s_w (W - z_w)`` the reference
    computes ``s_a s_w [A@W - z_w rowsum(A) - z_a colsum(W) + K z_a z_w]``
    (the ``planes`` and ``packed`` engines here, on the unsigned levels).
    ``int8`` and ``f32dot`` run the product on the centred levels
    ``C = A - z_a`` (int8, so ``C@W`` is one ``torch._int_mm``, or one
    float32 product), where the bracket is ``C@W - z_w rowsum(C)``: the
    same real number, and every term of both forms is an integer or
    half-integer far below 2^23, so both are exact in float32 and the
    engines agree bit for bit.

    ``a_scale``: None (per-tensor dynamic absmax), ``'row'`` (per-row), or
    a float (a static calibrated scale; the levels then in float32)."""
    if engine not in SIGNED_ENGINES:
        raise ValueError(f"signed level engine {engine!r} unknown "
                         f"(engines: {', '.join(SIGNED_ENGINES)})")
    lead = a.shape[:-1]
    k = a.shape[-1]
    a2 = a.reshape(-1, k)
    if a_scale == "row":
        a_lv, s_a, _ = activation_levels_signed_row(a2, a_bits)
    elif a_scale is not None:
        s_a = torch.tensor(a_scale, dtype=torch.float32, device=a.device)
        a_lv = signed_levels(a2.float(), s_a, a_bits)
    else:
        a_lv, s_a, _ = activation_levels_signed(a2, a_bits)
    z_a = 1 << (a_bits - 1)
    if engine in ("planes", "packed") or (engine == "int8"
                                          and w_lv.dtype != torch.int8):
        # the unsigned form also serves levels past int8 (w_bits = 8, float
        # weights quantized per call), as the reference's engines do
        acc = _ENGINES[engine](a_lv, w_lv.to(torch.int32), a_bits,
                               w_bits).to(torch.float32)
        rowsum = a_lv.sum(dim=-1, dtype=torch.int32).to(torch.float32)
        colsum = w_lv.sum(dim=0, dtype=torch.int32).to(torch.float32)
        bracket = (acc - z_w * rowsum[:, None] - z_a * colsum[None, :]
                   + k * z_a * z_w)
    else:
        c_lv = a_lv - z_a
        if engine == "int8":
            acc = centred_gemm_int(c_lv, w_lv).to(torch.float32)
        else:
            if not f32dot_exact(k, a_bits, w_bits):
                raise ValueError(f"f32dot engine inexact at K={k}, "
                                 f"a_bits={a_bits}, w_bits={w_bits}")
            acc = torch.matmul(c_lv.to(torch.float32),
                               w_lv.to(torch.float32))
        rowsum = c_lv.sum(dim=-1, dtype=torch.int32).to(torch.float32)
        bracket = acc - z_w * rowsum[:, None]
    out = bracket * (s_a.float() * s_w)
    return out.reshape(lead + (w_lv.shape[-1],)).to(a.dtype)


def quant_dense_forward_signed(a: torch.Tensor, w: torch.Tensor, a_bits: int,
                               w_bits: int, engine: str = "int8",
                               a_scale_mode: str = "tensor") -> torch.Tensor:
    """Signed quantized dense on float weights (a transformer projection
    served without prequantization): ``w`` (K, N) to levels here, then
    :func:`quant_dense_forward_signed_pre` with a per-tensor (``tensor``)
    or per-row (``row``) activation scale.  Levels up to 7 bits go in as
    int8, as :func:`repro_torch.models.layers.prequantize_params` stores
    them."""
    w_lv, s_w, z_w = weight_levels(w, w_bits)
    if w_bits <= 7:
        w_lv = w_lv.to(torch.int8)
    return quant_dense_forward_signed_pre(
        a, w_lv, s_w.float(), z_w.float(), a_bits, w_bits,
        a_scale="row" if a_scale_mode == "row" else None, engine=engine)

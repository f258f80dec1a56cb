"""Serve entry points and engine dispatch for the quantized layers, and the
attention engine dispatch (port of ``repro/kernels/ops.py``).

Every dense engine of the reference is ported, and all of them give the
same int32 level-GEMM accumulator and then run the one shared epilogue
(``and_accum.dequant_epilogue``), so their outputs are equal bit for bit:

* ``fused`` — the fused level GEMM, :mod:`.fused_qgemm`;
* ``implicit`` — the implicit-GEMM conv, :mod:`.conv_implicit`;
* ``depthwise`` — a depthwise 3x3 conv (``ConvShape.groups > 1``), each
  channel against its own nine weights, :mod:`.dwconv`: the only engine
  that computes one, and one that computes nothing else;
* ``faithful`` — the paper's Eq. (1): the activation levels packed into
  bit planes on the card (:mod:`.quantpack`, levels in), the weight planes
  packed once at plan compile, AND + popcount in :mod:`.bitgemm`;
* ``int8`` and ``int8_planewise`` — the products on :mod:`.bitgemm_mxu`'s
  s8 kernel, on the nibble groups of the levels or on single plane pairs;
* ``planes``, ``packed`` and ``f32dot`` — plain PyTorch, as the reference
  computes them in XLA (``f32dot`` a float32 matmul, TF32 off).

:func:`quant_dense_kernel` is the float-in entry point: quantize + pack on
the card, then the faithful or the MXU path.

An unpinned call resolves in the reference's order (:func:`select_engine`):
an installed plan's dense table, then the measured autotune cache
(:func:`autotune_engine`, which times each candidate as it is served, on
the device the problem's tensors live on), then the compute target's cost
model (:func:`cost_model_engine`).

Attention engines: ``full``, ``chunked`` and ``banded`` (plain PyTorch, as
the reference computes them in XLA), ``flash`` (``csrc/attn_flash.cu``) and
``paged`` (``csrc/attn_paged.cu``); :func:`select_attn_engine` consults the
installed plan's attention table before the target's decision procedure.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import bitplane
from repro_torch.core.and_accum import (_ENGINES, SIGNED_ENGINES,
                                        _nibble_split,
                                        dequant_epilogue, epilogue_scales,
                                        f32dot_exact, int32_exact)
from repro_torch.core.conv_lowering import _out_hw, im2col_sliced
from .bitgemm import bitgemm_packed, bitgemm_packed_plain
from .bitgemm_mxu import int8_exact, int8_matmul, int8_matmul_plain
from .conv_implicit import conv_implicit, conv_implicit_plain
from .dwconv import bounds as dwconv_bounds, dwconv, dwconv_plain
from .fused_qgemm import fused_qgemm, fused_qgemm_plain
from .quantpack import quantize_pack as _quantize_pack, quantize_pack_plain

ENGINES = ("fused", "implicit", "faithful", "planes", "packed", "int8",
           "int8_planewise", "f32dot", "depthwise")


@dataclasses.dataclass(frozen=True)
class ConvShape:
    """Static conv geometry (including batch) for engine selection."""
    h: int
    w: int
    kh: int
    kw: int
    stride: int
    padding: str
    batch: int = 1
    # a depthwise conv's channel count (each its own group), else 1
    groups: int = 1

    @property
    def out_hw(self) -> tuple[int, int]:
        return _out_hw(self.h, self.w, self.kh, self.kw, self.stride,
                       self.padding)

    @property
    def m(self) -> int:
        """GEMM rows of the whole batched problem: batch * oh * ow."""
        oh, ow = self.out_hw
        return self.batch * oh * ow

    @property
    def read_amplification(self) -> float:
        """im2col blowup: patch elements per input element (~kh*kw)."""
        oh, ow = self.out_hw
        return self.kh * self.kw * oh * ow / max(self.h * self.w, 1)


# ---------------------------------------------------------------------------
# Plan table + autotune cache: verdicts consulted before the cost model
# ---------------------------------------------------------------------------

# Dense-GEMM and attention verdicts installed by an active ModelPlan
# (core/plan.py), keyed by dense_plan_key / attn_plan_key tuples.  Conv
# verdicts never go through it: a CNN plan pins them per layer.
_PLAN_TABLE: dict = {}

# Measured verdicts: autotune_key -> (engine, {engine: microseconds}).
# Filled by autotune_engine, saved with a plan and restored by load_plan,
# so a reloaded node never measures again.
_AUTOTUNE_CACHE: dict = {}

# bumped whenever a table or cached verdict changes
_DISPATCH_EPOCH = [0]


def dispatch_epoch() -> int:
    return _DISPATCH_EPOCH[0]


def dense_plan_key(k: int, n: int, a_bits: int, w_bits: int,
                   backend: str) -> tuple:
    """Plan-table key of a dense serve GEMM: ``m``-free, so one verdict
    covers prefill and every decode step."""
    return ("dense", k, n, a_bits, w_bits, backend)


def autotune_key(m: int, k: int, n: int, a_bits: int, w_bits: int,
                 backend: str, conv: ConvShape | None) -> tuple:
    """Autotune-cache key.  ``backend`` is the type of the device the
    measurement ran on (``cuda`` / ``cpu``), so a CPU verdict is never
    read on the card, nor the reverse."""
    if conv is not None:
        return ("conv", conv.h, conv.w, conv.kh, conv.kw, conv.stride,
                conv.padding, conv.batch, k, n, a_bits, w_bits, backend)
    return ("dense", m, k, n, a_bits, w_bits, backend)


def install_plan_table(entries: dict) -> None:
    """Install a plan's verdicts (additive)."""
    _PLAN_TABLE.update(entries)
    _DISPATCH_EPOCH[0] += 1


def remove_plan_table(entries: dict) -> None:
    for key in entries:
        _PLAN_TABLE.pop(key, None)
    _DISPATCH_EPOCH[0] += 1


def clear_plan_state() -> None:
    """Drop every installed plan verdict and autotune measurement."""
    _PLAN_TABLE.clear()
    _AUTOTUNE_CACHE.clear()
    _DISPATCH_EPOCH[0] += 1


def select_engine(m: int, k: int, n: int, a_bits: int, w_bits: int,
                  target: str = "cuda", conv: ConvShape | None = None,
                  device=None) -> str:
    """The serve engine of an (m, k) x (k, n) level GEMM: (1) an installed
    plan's dense table (dense problems only), (2) the autotune cache
    (measured on ``device``'s type, ``target`` when None), (3) the cost
    model.  With no plan and no measurement this is the cost model."""
    if conv is None:
        hit = _PLAN_TABLE.get(dense_plan_key(k, n, a_bits, w_bits, target))
        if hit is not None:
            return hit
    backend = target if device is None else torch.device(device).type
    tuned = _AUTOTUNE_CACHE.get(autotune_key(m, k, n, a_bits, w_bits,
                                             backend, conv))
    if tuned is not None:
        return tuned[0]
    return cost_model_engine(m, k, n, a_bits, w_bits, target, conv)


def cost_model_engine(m: int, k: int, n: int, a_bits: int, w_bits: int,
                      target: str = "cuda",
                      conv: ConvShape | None = None) -> str:
    """The compute target's cost model (no tables, no measurement)."""
    from repro_torch.api.targets import get_target

    return get_target(target).select_engine(m, k, n, a_bits, w_bits, conv)


def engine_feasible(engine: str, m: int, k: int, n: int, a_bits: int,
                    w_bits: int, target: str = "cuda",
                    conv: ConvShape | None = None) -> tuple[bool, str]:
    """Can ``engine`` realize this problem on ``target``?  ``(ok, reason)``."""
    from repro_torch.api.targets import (IMPLICIT_PADDINGS, IMPLICIT_STRIDES,
                                         get_target)

    if engine not in ENGINES:
        return False, f"unknown engine {engine!r}"
    if not (a_bits <= 8 and w_bits <= 8):
        return False, (f"the kernels take uint8 levels (a_bits={a_bits}, "
                       f"w_bits={w_bits})")
    if engine == "faithful":   # the kernel sums whole words of K
        k = -(-k // bitplane.LANE) * bitplane.LANE
    if not int32_exact(k, a_bits, w_bits):
        return False, (f"int32 accumulator may overflow at K={k}, "
                       f"a_bits={a_bits}, w_bits={w_bits}")
    depthwise = conv is not None and conv.groups > 1
    if engine == "depthwise" or depthwise:
        if not depthwise:
            return False, ("depthwise computes only depthwise convs "
                           "(groups == cout, cin == 1)")
        if engine != "depthwise":
            return False, (f"{engine} computes a dense conv; only "
                           f"depthwise computes a depthwise one")
        return dwconv_bounds(conv.kh, conv.kw, conv.stride, conv.padding, n)
    if engine in ("int8", "int8_planewise") and not int8_exact(k):
        return False, (f"an s8 x s8 partial sum may overflow int32 at K={k}")
    if engine == "f32dot" and not f32dot_exact(k, a_bits, w_bits):
        return False, (f"f32dot inexact at K={k}, a_bits={a_bits}, "
                       f"w_bits={w_bits} (accumulator exceeds the fp32 "
                       "mantissa)")
    if engine != "implicit":
        return True, ""
    if conv is None:
        return False, "implicit is a conv engine (no conv geometry here)"
    if conv.kh * conv.kw <= 1:
        return False, "1x1 conv has no patch amplification (im2col is the identity)"
    if conv.stride not in IMPLICIT_STRIDES:
        return False, f"stride {conv.stride} unsupported (routing covers {IMPLICIT_STRIDES})"
    if conv.padding not in IMPLICIT_PADDINGS:
        return False, f"padding {conv.padding!r} unsupported"
    need, budget = get_target(target).implicit_smem(conv, k, n)
    if need > budget:
        return False, (f"one block needs {need} B of shared memory "
                       f"(> {budget} B)")
    return True, ""


# ---------------------------------------------------------------------------
# Autotune: time the feasible engines at the real shape, cache the verdict
# ---------------------------------------------------------------------------

def candidate_engines(m: int, k: int, n: int, a_bits: int, w_bits: int,
                      target: str = "cuda", conv: ConvShape | None = None,
                      signed: bool = False) -> list[str]:
    """Feasible engines worth timing, in the reference's order.  The
    bit-plane loop engines are left out (never latency-competitive);
    ``faithful`` only for binary operands; ``signed`` keeps the engines
    of the signed LM path."""
    out = []
    for eng in ("implicit", "fused", "faithful", "f32dot", "int8"):
        if eng == "faithful" and not (a_bits == 1 and w_bits == 1):
            continue
        if signed and eng not in SIGNED_ENGINES:
            continue
        if engine_feasible(eng, m, k, n, a_bits, w_bits, target, conv)[0]:
            out.append(eng)
    return out


def _time_engine(fn, *args, repeats: int = 3, device=None) -> float:
    """Best-of-``repeats`` wall microseconds of ``fn(*args)`` after one
    warm call, the card synchronized before and after each call."""
    sync = (torch.cuda.synchronize if torch.device(device or "cpu").type
            == "cuda" else (lambda: None))
    fn(*args)
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def autotune_engine(m: int, k: int, n: int, a_bits: int, w_bits: int,
                    target: str = "cuda", conv: ConvShape | None = None,
                    repeats: int = 3, device=None, signed: bool = False,
                    act_dtype=torch.float32) -> tuple[str, dict]:
    """Measure the candidate engines on ``device`` (default: the
    ``target``'s own device) and cache the verdict: ``(engine, {engine:
    us})``.  Random levels from ``np.random.RandomState(0)`` at the real
    shape stand in for data (an engine's time does not depend on the
    values).  Each engine is timed as it is served: ``quant_conv_serve`` /
    ``quant_dense_serve`` on levels (the faithful weights packed once, as
    a plan packs them), or with ``signed`` the LM path's
    ``quant_dense_forward_signed_pre`` on ``act_dtype`` activations.  The
    cache key's backend slot is the device's type."""
    from repro_torch.core.and_accum import quant_dense_forward_signed_pre

    device = torch.device(device if device is not None else target)
    key = autotune_key(m, k, n, a_bits, w_bits, device.type, conv)
    if signed:
        key = ("signed",) + key[1:]
    hit = _AUTOTUNE_CACHE.get(key)
    if hit is not None:
        return hit
    cands = candidate_engines(m, k, n, a_bits, w_bits, target, conv, signed)
    if len(cands) < 2:
        verdict = (cands[0] if cands else
                   cost_model_engine(m, k, n, a_bits, w_bits, target, conv),
                   {})
        _AUTOTUNE_CACHE[key] = verdict
        _DISPATCH_EPOCH[0] += 1
        return verdict
    rng = np.random.RandomState(0)
    top_w = (1 << w_bits) - 1
    w_lv = torch.from_numpy(rng.randint(0, top_w + 1, size=(k, n)).astype(
        np.int8 if signed else np.uint8)).to(device)
    s_w = float(np.float32(2.0 / max(top_w, 1)))
    z_w = float(np.float32(top_w / 2.0))
    timings: dict[str, float] = {}
    for eng in cands:
        if signed:
            x = torch.from_numpy(rng.normal(size=(m, k)).astype(
                np.float32)).to(device=device, dtype=act_dtype)
            sw = torch.tensor(s_w, device=device)
            zw = torch.tensor(z_w, device=device)
            timings[eng] = _time_engine(
                lambda: quant_dense_forward_signed_pre(
                    x, w_lv, sw, zw, a_bits, w_bits, engine=eng),
                repeats=repeats, device=device)
            continue
        planes = (pack_weight_planes(w_lv, w_bits) if eng == "faithful"
                  else None)
        if conv is not None:
            cin = k // (conv.kh * conv.kw)
            x_lv = rng.randint(0, 1 << a_bits,
                               size=(conv.batch, conv.h, conv.w, cin))
            fn = lambda x: quant_conv_serve(  # noqa: E731
                x, w_lv, s_w, z_w, kh=conv.kh, kw=conv.kw,
                stride=conv.stride, padding=conv.padding, a_bits=a_bits,
                w_bits=w_bits, engine=eng, w_planes=planes)
        else:
            x_lv = rng.randint(0, 1 << a_bits, size=(m, k))
            fn = lambda x: quant_dense_serve(  # noqa: E731
                x, w_lv, s_w, z_w, a_bits=a_bits, w_bits=w_bits, engine=eng,
                w_planes=planes)
        x_lv = torch.from_numpy(x_lv.astype(np.uint8)).to(device)
        timings[eng] = _time_engine(fn, x_lv, repeats=repeats, device=device)
    best = min(timings, key=timings.get)
    _AUTOTUNE_CACHE[key] = (best, timings)
    _DISPATCH_EPOCH[0] += 1
    return best, timings


# ---------------------------------------------------------------------------
# The level GEMM engines on the kernels
# ---------------------------------------------------------------------------

def pack_weight_planes(w_lv: torch.Tensor, w_bits: int) -> torch.Tensor:
    """(K, N) weight levels -> (w_bits, N, ceil(K/32)) packed planes, the
    faithful kernel's weight operand (pre-transposed, as the reference's
    kernel takes it).  Plain PyTorch, as the reference packs its weights
    in XLA; a compiled plan packs them once."""
    return bitplane.decompose_packed(w_lv.T, w_bits).contiguous()


def quantize_pack(a: torch.Tensor, bits: int, *, reference: bool = False):
    """Fused quantize + pack (kernel): (M, K) float32 activations or uint8
    levels -> ``(levels uint8, planes int32 (bits, M, ceil(K/32)))``."""
    return (quantize_pack_plain if reference else _quantize_pack)(a, bits)


def bitgemm_faithful(a_lv: torch.Tensor, w_lv: torch.Tensor, a_bits: int,
                     w_bits: int, *, w_planes: torch.Tensor | None = None,
                     reference: bool = False) -> torch.Tensor:
    """Paper-faithful path: pack the activation levels into planes
    (``quantize_pack``, levels in), AND + popcount (``bitgemm_packed``).
    ``w_planes``: the weights already packed (:func:`pack_weight_planes`);
    packed here when None."""
    if w_planes is None:
        w_planes = pack_weight_planes(w_lv, w_bits)
    _, a_planes = quantize_pack(a_lv.to(torch.uint8).contiguous(), a_bits,
                                reference=reference)
    gemm = bitgemm_packed_plain if reference else bitgemm_packed
    return gemm(a_planes, w_planes, a_bits=a_bits, w_bits=w_bits)


def _as_int8(x: torch.Tensor) -> torch.Tensor:
    """Levels below 128 as an int8 operand (uint8 reinterpreted, no copy)."""
    x = x.view(torch.int8) if x.dtype == torch.uint8 else x.to(torch.int8)
    return x.contiguous()


def bitgemm_mxu(a_lv: torch.Tensor, w_lv: torch.Tensor, a_bits: int,
                w_bits: int, *, reference: bool = False) -> torch.Tensor:
    """The int8 engine on the s8 kernel: one product per pair of nibble
    groups (one product in all for levels of at most 7 bits)."""
    mm = int8_matmul_plain if reference else int8_matmul
    w_groups = [(_as_int8(g), s) for g, s in _nibble_split(w_lv, w_bits)]
    parts = [(mm(_as_int8(ga), gw), sa + sw)
             for ga, sa in _nibble_split(a_lv, a_bits) for gw, sw in w_groups]
    return _shift_sum(parts)


def _shift_sum(parts) -> torch.Tensor:
    """``sum(d << s)`` over (int32 product, shift) pairs, accumulated into
    the first (unshifted) product in place."""
    out = parts[0][0]
    for d, s in parts[1:]:
        out += d << s
    return out


def bitgemm_mxu_planewise(a_lv: torch.Tensor, w_lv: torch.Tensor,
                          a_bits: int, w_bits: int, *,
                          reference: bool = False) -> torch.Tensor:
    """The int8_planewise engine on the s8 kernel: one product per plane
    pair, shifted by m+n (Eq. 1 with the CMP done by the product)."""
    mm = int8_matmul_plain if reference else int8_matmul
    pa = bitplane.decompose(a_lv, a_bits).to(torch.int8)
    pw = bitplane.decompose(w_lv, w_bits).to(torch.int8)
    return _shift_sum([(mm(pa[m], pw[n]), m + n) for m in range(a_bits)
                       for n in range(w_bits)])


# ---------------------------------------------------------------------------
# Serve entry points
# ---------------------------------------------------------------------------

def quant_dense_serve(a_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                      a_bits: int, w_bits: int, engine: str | None = None,
                      w_planes: torch.Tensor | None = None,
                      reference: bool = False) -> torch.Tensor:
    """Dense on pre-quantized operands: (M, K) uint8 activation levels x
    (K, N) uint8 weight levels -> (M, N) float32.  ``w_planes``: the
    weights packed for the faithful engine (packed per call when None).

    ``reference=True`` runs the kernels' plain versions on whatever device
    the operands live on — the caller's explicit request for the oracle
    (used to hold the card's kernels against their plain versions), never
    a fallback."""
    m, k = a_lv.shape
    n = w_lv.shape[1]
    if engine is None:
        engine = select_engine(m, k, n, a_bits, w_bits, device=a_lv.device)
    if engine == "fused":
        fn = fused_qgemm_plain if reference else fused_qgemm
        return fn(a_lv, w_lv, s_w, z_w, a_bits=a_bits, w_bits=w_bits,
                  a_is_levels=True)
    if engine == "faithful":
        acc = bitgemm_faithful(a_lv, w_lv, a_bits, w_bits, w_planes=w_planes,
                               reference=reference)
    elif engine == "int8":
        acc = bitgemm_mxu(a_lv, w_lv, a_bits, w_bits, reference=reference)
    elif engine == "int8_planewise":
        acc = bitgemm_mxu_planewise(a_lv, w_lv, a_bits, w_bits,
                                    reference=reference)
    elif engine in _ENGINES:   # planes, packed, f32dot: plain PyTorch
        acc = _ENGINES[engine](a_lv, w_lv, a_bits, w_bits)
    else:
        raise ValueError(f"unknown dense engine {engine!r} (engines: "
                         f"{', '.join(e for e in ENGINES if e != 'implicit')})")
    s, t = epilogue_scales(a_bits, s_w, z_w)
    return dequant_epilogue(acc, a_lv.sum(dim=1, dtype=torch.int32), s, t)


def quant_conv_serve(x_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                     kh: int, kw: int, stride: int = 1, padding: str = "SAME",
                     a_bits: int, w_bits: int, engine: str | None = None,
                     w_planes: torch.Tensor | None = None,
                     reference: bool = False) -> torch.Tensor:
    """Conv on pre-quantized operands: (B,H,W,Cin) uint8 levels, (kh*kw*Cin,
    Cout) uint8 weight levels -> (B,OH,OW,Cout) float32.  ``implicit`` never
    materializes patches; ``depthwise`` takes a depthwise conv's (kh*kw,
    C) weights; every other engine lowers through ``im2col_sliced`` to
    :func:`quant_dense_serve`."""
    b, h, w, cin = x_lv.shape
    cout = w_lv.shape[1]
    oh, ow = _out_hw(h, w, kh, kw, stride, padding)
    if engine is None:
        engine = select_engine(
            b * oh * ow, kh * kw * cin, cout, a_bits, w_bits,
            conv=ConvShape(h, w, kh, kw, stride, padding, batch=b),
            device=x_lv.device)
    if engine == "implicit":
        fn = conv_implicit_plain if reference else conv_implicit
        return fn(x_lv, w_lv, s_w, z_w, kh=kh, kw=kw, stride=stride,
                  padding=padding, a_bits=a_bits, w_bits=w_bits)
    if engine == "depthwise":
        fn = dwconv_plain if reference else dwconv
        return fn(x_lv, w_lv, s_w, z_w, stride=stride, a_bits=a_bits,
                  w_bits=w_bits)
    patches = im2col_sliced(x_lv, kh, kw, stride, padding)
    out = quant_dense_serve(patches.reshape(-1, kh * kw * cin), w_lv, s_w,
                            z_w, a_bits=a_bits, w_bits=w_bits, engine=engine,
                            w_planes=w_planes, reference=reference)
    return out.reshape(b, oh, ow, cout)


def quant_dense_kernel(a: torch.Tensor, w: torch.Tensor, a_bits: int,
                       w_bits: int, path: str = "mxu", *,
                       reference: bool = False) -> torch.Tensor:
    """Float-in quantized dense on the kernels: quantize + pack, then
    AND + popcount (``path="faithful"``) or the s8 products on the levels
    (``path="mxu"``), then the shared epilogue.  ``a`` (..., K) float, ``w``
    (K, N) float, quantized here with ``weight_levels``."""
    from repro_torch.core.quant import weight_levels

    if path not in ("mxu", "faithful"):
        raise ValueError(f"quant_dense_kernel: path must be 'mxu' or "
                         f"'faithful', got {path!r}")
    if not (1 <= a_bits <= 8 and 1 <= w_bits <= 8):
        raise ValueError(f"quant_dense_kernel: bit widths must be 1..8, got "
                         f"a={a_bits} w={w_bits}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).to(torch.float32).contiguous()
    a_lv, a_planes = quantize_pack(a2, a_bits, reference=reference)
    w_lv, s_w, z_w = weight_levels(w, w_bits)
    w_lv = w_lv.to(torch.uint8)
    if path == "faithful":
        gemm = bitgemm_packed_plain if reference else bitgemm_packed
        acc = gemm(a_planes, pack_weight_planes(w_lv, w_bits), a_bits=a_bits,
                   w_bits=w_bits)
    else:
        acc = bitgemm_mxu(a_lv, w_lv, a_bits, w_bits, reference=reference)
    s, t = epilogue_scales(a_bits, float(s_w), float(z_w))
    out = dequant_epilogue(acc, a_lv.sum(dim=1, dtype=torch.int32), s, t)
    return out.reshape(lead + (w.shape[-1],)).to(a.dtype)


# ---------------------------------------------------------------------------
# Attention engine dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnShape:
    """Static attention geometry for engine selection.  ``quantized`` marks
    a serve path whose projections already run on integer levels (only
    then may the quantized flash kernel be dispatched); ``page_size`` set
    makes this a page-table dispatch, ``seq_kv`` then being the table
    extent (table width * page_size)."""
    seq_q: int
    seq_kv: int
    heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None
    batch: int = 1
    quantized: bool = False
    banded_ok: bool = True
    page_size: int | None = None


ATTN_ENGINES = ("full", "chunked", "banded", "flash", "paged")


def paged_attn_bounds(attn: AttnShape, batch: int = 1) -> tuple[bool, str]:
    """Static feasibility bounds for the paged engine: the page size tiles
    the table extent, the flat KV index fits int32, and one
    ``csrc/attn_paged.cu`` block's shared memory fits the card.  The
    reference's bound is a TPU VMEM budget (``PAGED_VMEM_BUDGET``); here it
    is the kernel's own layout, bounded for the worst GQA grouping (every
    query head on one KV head) and float32 pools."""
    from .attn_flash import (SMEM_LIMIT, paged_heads_per_block,
                             paged_smem_bytes)

    ps = attn.page_size
    if not ps or ps < 1:
        return False, "paged needs a positive page_size"
    if attn.seq_kv % ps != 0:
        return False, (f"page_size={ps} does not tile the table extent "
                       f"seq_kv={attn.seq_kv}")
    flat = batch * attn.seq_kv * attn.heads * attn.head_dim
    if flat >= (1 << 31):
        return False, (f"flat KV index {flat} overflows int32 "
                       f"(batch={batch}, seq_kv={attn.seq_kv})")
    rows = paged_heads_per_block(attn.heads, attn.seq_q) * attn.seq_q
    need = paged_smem_bytes(rows, attn.head_dim)
    if need > SMEM_LIMIT:
        return False, (f"a paged block needs {need} B of shared memory "
                       f"(> {SMEM_LIMIT})")
    return True, ""


def attn_engine_feasible(engine: str, attn: AttnShape) -> tuple[bool, str]:
    """Can ``engine`` realize this attention geometry on the port?"""
    from .attn_flash import (KERNEL_HEAD_DIMS, PAGED_HEAD_DIMS,
                             flash_levels_exact)

    if engine == "banded":
        if not attn.window:
            return False, ("banded is the sliding-window realization (no "
                           "window here)")
        return True, ""
    if engine == "flash":
        if not attn.quantized:
            return False, ("flash consumes level-quantized q/k; dispatching"
                           " it on an unquantized path would change numerics")
        if attn.seq_q <= 1:
            return False, "flash tiles over q blocks (decode steps stay full)"
        if not flash_levels_exact(attn.head_dim, 8, 8):
            return False, (f"flash score dot inexact at head_dim="
                           f"{attn.head_dim} (exceeds the fp32 mantissa)")
        if attn.head_dim not in KERNEL_HEAD_DIMS:
            return False, (f"the flash kernel takes head_dim in "
                           f"{KERNEL_HEAD_DIMS}, not {attn.head_dim}")
        return True, ""
    if engine == "paged":
        ok, why = paged_attn_bounds(attn, batch=max(attn.batch, 1))
        if not ok:
            return False, why
        if attn.quantized and not flash_levels_exact(attn.head_dim, 8, 8):
            return False, (f"paged score dot inexact at head_dim="
                           f"{attn.head_dim} (exceeds the fp32 mantissa)")
        if attn.quantized and attn.head_dim not in PAGED_HEAD_DIMS:
            return False, (f"the paged kernel takes head_dim in "
                           f"{PAGED_HEAD_DIMS}, not {attn.head_dim}")
        return True, ""
    if engine in ("full", "chunked"):
        ok = attn.page_size is None
        return ok, "" if ok else (f"{engine} is a contiguous-KV engine; "
                                  "page-table geometries dispatch 'paged'")
    return False, f"unknown attention engine {engine!r}"


def attn_plan_key(attn: AttnShape, backend: str) -> tuple:
    """Plan-table key of an attention dispatch: keeps the sequence length
    (the crossovers are about S), drops the batch; paged dispatches add
    ``(page_size, seq_kv)`` (10-tuple; contiguous keys are 8-tuples)."""
    key = ("attn", attn.seq_q, attn.heads, attn.head_dim,
           bool(attn.causal), attn.window or 0, bool(attn.quantized),
           backend)
    if attn.page_size:
        key = key + (attn.page_size, attn.seq_kv)
    return key


def select_attn_engine(attn: AttnShape, target: str = "cuda") -> str:
    """The attention engine: an installed plan's attention table first,
    then the compute target's decision procedure."""
    from repro_torch.api.targets import get_target

    hit = _PLAN_TABLE.get(attn_plan_key(attn, target))
    if hit is not None:
        return hit
    return get_target(target).select_attn_engine(attn)

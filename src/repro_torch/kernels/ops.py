"""Serve entry points and engine dispatch for the quantized layers, and the
attention engine dispatch (port of ``repro/kernels/ops.py``).

Two engines are ported, one per hand-written kernel: ``fused`` (the fused
level GEMM, :mod:`.fused_qgemm`) and ``implicit`` (the implicit-GEMM conv,
:mod:`.conv_implicit`).  The reference's other engines (``faithful``,
``planes``, ``packed``, ``int8``, ``int8_planewise``, ``f32dot``) are not
ported yet; asking for one raises.

An unpinned call takes the compute target's cost model.  Not ported yet:
the reference's dense and attention plan tables (they serve the LM compile
pass) and its measured autotune layer.

Attention engines: ``full`` (plain PyTorch, as the reference computes it
in XLA), ``flash`` (``csrc/attn_flash.cu``) and ``paged``
(``csrc/attn_paged.cu``) are ported; ``chunked`` and ``banded`` are not.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.conv_lowering import _out_hw, im2col_sliced
from .conv_implicit import conv_implicit, conv_implicit_plain
from .fused_qgemm import fused_qgemm, fused_qgemm_plain

PORTED_ENGINES = ("fused", "implicit")
UNPORTED_ENGINES = ("faithful", "planes", "packed", "int8",
                    "int8_planewise", "f32dot")


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


def select_engine(m: int, k: int, n: int, a_bits: int, w_bits: int,
                  target: str = "cuda", conv: ConvShape | None = None) -> str:
    """The compute target's cost model (the reference's
    ``cost_model_engine``; with no plan table or autotune in front of it,
    the port needs no second name)."""
    from repro_torch.api.targets import get_target

    return get_target(target).select_engine(m, k, n, a_bits, w_bits, conv)


def engine_feasible(engine: str, m: int, k: int, n: int, a_bits: int,
                    w_bits: int, target: str = "cuda",
                    conv: ConvShape | None = None) -> tuple[bool, str]:
    """Can ``engine`` realize this problem on ``target``?  ``(ok, reason)``."""
    from repro_torch.api.targets import (IMPLICIT_PADDINGS, IMPLICIT_STRIDES,
                                         get_target)
    from repro_torch.core.and_accum import int32_exact

    if engine in UNPORTED_ENGINES:
        return False, (f"engine {engine!r} is not yet ported to "
                       f"{target!r} (ported: {', '.join(PORTED_ENGINES)})")
    if engine not in PORTED_ENGINES:
        return False, f"unknown engine {engine!r}"
    if not (a_bits <= 8 and w_bits <= 8):
        return False, (f"the kernels take uint8 levels (a_bits={a_bits}, "
                       f"w_bits={w_bits})")
    if not int32_exact(k, a_bits, w_bits):
        return False, (f"int32 accumulator may overflow at K={k}, "
                       f"a_bits={a_bits}, w_bits={w_bits}")
    if engine == "fused":
        return True, ""
    if conv is None:
        return False, "implicit is a conv engine (no conv geometry here)"
    if conv.kh * conv.kw <= 1:
        return False, "1x1 conv has no patch amplification (im2col is the identity)"
    if conv.stride not in IMPLICIT_STRIDES:
        return False, f"stride {conv.stride} unsupported (routing covers {IMPLICIT_STRIDES})"
    if conv.padding not in IMPLICIT_PADDINGS:
        return False, f"padding {conv.padding!r} unsupported"
    need, budget = get_target(target).implicit_smem(conv, k)
    if need > budget:
        return False, (f"one block needs {need} B of shared memory "
                       f"(> {budget} B)")
    return True, ""


# ---------------------------------------------------------------------------
# Serve entry points
# ---------------------------------------------------------------------------

def quant_dense_serve(a_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                      a_bits: int, w_bits: int, engine: str | None = None,
                      reference: bool = False) -> torch.Tensor:
    """Dense on pre-quantized operands: (M, K) uint8 activation levels x
    (K, N) uint8 weight levels -> (M, N) float32.

    ``reference=True`` runs the kernel's plain version on whatever device
    the operands live on — the caller's explicit request for the oracle
    (used to hold the card's kernels against their plain versions), never
    a fallback."""
    m, k = a_lv.shape
    n = w_lv.shape[1]
    if engine is None:
        engine = select_engine(m, k, n, a_bits, w_bits)
    if engine != "fused":
        raise ValueError(f"dense engine {engine!r} is not yet ported "
                         f"(ported: 'fused')")
    fn = fused_qgemm_plain if reference else fused_qgemm
    return fn(a_lv, w_lv, s_w, z_w, a_bits=a_bits, w_bits=w_bits,
              a_is_levels=True)


def quant_conv_serve(x_lv: torch.Tensor, w_lv: torch.Tensor, s_w, z_w, *,
                     kh: int, kw: int, stride: int = 1, padding: str = "SAME",
                     a_bits: int, w_bits: int, engine: str | None = None,
                     reference: bool = False) -> torch.Tensor:
    """Conv on pre-quantized operands: (B,H,W,Cin) uint8 levels, (kh*kw*Cin,
    Cout) uint8 weight levels -> (B,OH,OW,Cout) float32.  ``implicit`` never
    materializes patches; ``fused`` lowers through ``im2col_sliced``."""
    b, h, w, cin = x_lv.shape
    cout = w_lv.shape[1]
    oh, ow = _out_hw(h, w, kh, kw, stride, padding)
    if engine is None:
        engine = select_engine(
            b * oh * ow, kh * kw * cin, cout, a_bits, w_bits,
            conv=ConvShape(h, w, kh, kw, stride, padding, batch=b))
    if engine == "implicit":
        fn = conv_implicit_plain if reference else conv_implicit
        return fn(x_lv, w_lv, s_w, z_w, kh=kh, kw=kw, stride=stride,
                  padding=padding, a_bits=a_bits, w_bits=w_bits)
    patches = im2col_sliced(x_lv, kh, kw, stride, padding)
    out = quant_dense_serve(patches.reshape(-1, kh * kw * cin), w_lv, s_w,
                            z_w, a_bits=a_bits, w_bits=w_bits, engine=engine,
                            reference=reference)
    return out.reshape(b, oh, ow, cout)


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
    query head on one KV head)."""
    from .attn_flash import SMEM_LIMIT, paged_smem_bytes

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
    need = paged_smem_bytes(attn.heads * attn.seq_q, attn.head_dim, ps)
    if need > SMEM_LIMIT:
        return False, (f"a paged block needs {need} B of shared memory "
                       f"(> {SMEM_LIMIT})")
    return True, ""


def attn_engine_feasible(engine: str, attn: AttnShape) -> tuple[bool, str]:
    """Can ``engine`` realize this attention geometry on the port?"""
    from .attn_flash import KERNEL_HEAD_DIMS, flash_levels_exact

    if engine in ("chunked", "banded"):
        return False, f"attention engine {engine!r} is not yet ported"
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
        return True, ""
    if engine == "full":
        ok = attn.page_size is None
        return ok, "" if ok else ("full is a contiguous-KV engine; "
                                  "page-table geometries dispatch 'paged'")
    return False, f"unknown attention engine {engine!r}"


def select_attn_engine(attn: AttnShape, target: str = "cuda") -> str:
    """The compute target's attention decision procedure (no plan table in
    front of it yet)."""
    from repro_torch.api.targets import get_target

    return get_target(target).select_attn_engine(attn)

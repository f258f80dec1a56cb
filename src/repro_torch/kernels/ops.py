"""Serve entry points and engine dispatch for the quantized layers (port of
the CNN half of ``repro/kernels/ops.py``).

Two engines are ported, one per hand-written kernel: ``fused`` (the fused
level GEMM, :mod:`.fused_qgemm`) and ``implicit`` (the implicit-GEMM conv,
:mod:`.conv_implicit`).  The reference's other engines (``faithful``,
``planes``, ``packed``, ``int8``, ``int8_planewise``, ``f32dot``) are not
ported yet; asking for one raises.

An unpinned call takes the compute target's cost model.  Not ported yet:
the reference's dense plan table (it serves the LM compile pass) and its
measured autotune layer.
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

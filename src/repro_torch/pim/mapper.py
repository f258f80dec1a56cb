"""Map bit-wise CNN layers onto computational sub-arrays (paper Fig. 3) and
count row-operations/cycles/energy per design (port of
``repro/pim/mapper.py``, with the reference's arithmetic and float order,
so every figure is the reference's float exactly).  The work comes from a
spec walk (:func:`layer_work`, :func:`model_work`) or from a compiled
plan's layers (:func:`works_from_layers`); :func:`compare_designs` prices
one model on the four designs.

For a conv layer with K = kh*kw*Cin inputs per output, m-bit activations and
n-bit weights:
  bit products    = out_elems * K * m * n
  row operations  = bit products / 512           (one row-AND covers 512 cells)
  per row-op      : AND sense -> result write-back -> CMP -> shift/accum
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

from .energy import CLOCK_GHZ, DESIGNS, SUBARRAY_COLS, DeviceModel

if TYPE_CHECKING:
    from repro_torch.models.cnn import ConvSpec


@dataclasses.dataclass
class LayerWork:
    macs: int
    bit_products: int
    row_ops: int


def layer_work(spec: "ConvSpec", in_hw: int, m_bits: int,
               n_bits: int) -> tuple[LayerWork, int]:
    """Returns (work, out_hw).  The conv output is the ceil-div of the
    input extent by the stride, the 2x2 pool halves it afterwards, floored
    at 1 (a pooled 1x1 map cannot collapse later layers to zero extent);
    FC layers reduce to 1x1 whatever their input extent."""
    if in_hw < 1:
        raise ValueError(f"layer_work: input extent must be >= 1, got {in_hw}")
    oh = 1 if spec.fc else max(-(-in_hw // spec.stride), 1)
    macs = oh * oh * spec.k * spec.k * spec.cin * spec.cout
    bitp = macs * m_bits * n_bits
    return LayerWork(macs=macs, bit_products=bitp,
                     row_ops=-(-bitp // SUBARRAY_COLS)), \
        (max(oh // 2, 1) if spec.pool else oh)


def model_work(specs: Sequence["ConvSpec"], img: int, m_bits: int,
               n_bits: int, quant_first_last_fp: bool = True
               ) -> list[LayerWork]:
    """Per-layer work; first/last layers run at 8-bit fixed point
    in-memory (their full-precision policy)."""
    hw = img
    works = []
    for s in specs:
        mb, nb = m_bits, n_bits
        if quant_first_last_fp and s.role in ("first", "last"):
            mb, nb = 8, 8
        w, hw = layer_work(s, hw, mb, nb)
        works.append(w)
    return works


def effective_bits(lp) -> tuple[int, int]:
    """(a_bits, w_bits) a layer executes at: full-precision layers run as
    8-bit fixed point in-memory."""
    return (8, 8) if lp.fp else (lp.a_bits, lp.w_bits)


def works_from_layers(layers: Sequence) -> list[LayerWork]:
    """Per-layer work from compiled ``LayerPlan`` records (duck-typed:
    anything with ``out_h/out_w/kh/kw/cin/cout/fp/a_bits/w_bits``)."""
    works = []
    for lp in layers:
        mb, nb = effective_bits(lp)
        macs = lp.out_h * lp.out_w * lp.kh * lp.kw * lp.cin * lp.cout
        bitp = macs * mb * nb
        works.append(LayerWork(macs=macs, bit_products=bitp,
                               row_ops=-(-bitp // SUBARRAY_COLS)))
    return works


def accel_cost(design: DeviceModel, works: Sequence[LayerWork]) -> dict:
    """Energy (uJ) and latency (us) for one image on one design."""
    if not works:
        raise ValueError("accel_cost: empty works — map at least one layer "
                         "before costing a design")
    total_macs = sum(w.macs for w in works)
    total_rows = sum(w.row_ops for w in works)
    if design.e_mac_asic:  # CMOS ASIC path
        cycles = total_macs / max(design.c_macs_per_cycle, 1)
        energy_pj = total_macs * design.e_mac_asic + cycles * design.e_static_per_cycle
    else:
        per_row_cycles = design.c_and + design.c_write + design.c_cmp + design.c_accum
        par = max(design.n_parallel_subarrays, 1)
        cycles = total_rows * per_row_cycles / par
        energy_pj = total_rows * (
            design.e_and_row + design.e_write_row + design.e_cmp_row + design.e_accum
        ) + cycles * design.e_static_per_cycle
    latency_us = cycles / (CLOCK_GHZ * 1e3)
    return dict(
        energy_uj=energy_pj * 1e-6,
        latency_us=latency_us,
        fps=1e6 / latency_us if latency_us else float("inf"),
        macs=total_macs,
        row_ops=total_rows,
    )


def compare_designs(specs, img: int, m_bits: int, n_bits: int,
                    area_mm2: dict[str, float] | None = None
                    ) -> dict[str, dict]:
    """Run all four designs over one model; optionally area-normalize
    (``area_mm2`` by design name, e.g. ``energy.TABLE2_AREA_MM2``)."""
    out = {}
    for name, d in DESIGNS.items():
        works = model_work(specs, img, m_bits, n_bits)
        r = accel_cost(d, works)
        if area_mm2 and name in area_mm2 and area_mm2[name]:
            r["fps_per_mm2"] = r["fps"] / area_mm2[name]
            r["eff_per_mm2"] = ((r["macs"] * 2 / (r["energy_uj"] * 1e-6))
                                / area_mm2[name])
        r["gops_per_w"] = (r["macs"] * 2e-9) / (r["energy_uj"] * 1e-6)
        out[name] = r
    return out

"""Map bit-wise CNN layers onto computational sub-arrays (paper Fig. 3) and
count row-operations/cycles/energy per design — the part of
``repro/pim/mapper.py`` that prices compiled plans, copied so the port's
``simulate`` gives the reference's floats exactly.

For a conv layer with K = kh*kw*Cin inputs per output, m-bit activations and
n-bit weights:
  bit products    = out_elems * K * m * n
  row operations  = bit products / 512           (one row-AND covers 512 cells)
  per row-op      : AND sense -> result write-back -> CMP -> shift/accum
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .energy import CLOCK_GHZ, SUBARRAY_COLS, DeviceModel


@dataclasses.dataclass
class LayerWork:
    macs: int
    bit_products: int
    row_ops: int


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

"""Hardware target registry (port of ``repro/api/targets.py``).

Two kinds of target:

* :class:`ComputeTarget` — the serve backend.  The port has one, ``cuda``
  (an H100).  Its ``cost()`` is the reference's roofline formula (compute-
  vs bandwidth-bound cycles, energy per op and per byte) over the H100's
  data-sheet figures: the annotation a compiled plan carries per layer
  (``attn_cost`` for an LM plan's attention rows) and the currency of the
  resilience degrade budget.  It routes as the reference's TPU target does — ``implicit``
  for deep-K spatial convs whose block fits shared memory, ``fused``
  otherwise — with the TPU's 8 MiB VMEM residency bound replaced by the
  shared-memory bound of the port's implicit kernel, computed by the same
  function the kernel wrapper uses.  Every other dense engine of the
  reference (``faithful``, ``planes``, ``packed``, ``int8``,
  ``int8_planewise``, ``f32dot``) is feasible under its exactness bound
  when a ``QuantConfig`` names it (``ops.engine_feasible``), but the
  automatic routing never picks one: the TPU target's crossover to
  ``faithful`` (binary, huge-K, skinny layers) is a TPU constant, and no
  crossover has been measured on the card; a compile with
  ``autotune=True`` measures the candidates there instead.  Attention
  routes as the TPU target does too (``paged`` for page-table geometries,
  ``flash`` for quantized prefill from 2048 tokens, ``banded`` for long
  windowed prefill, ``chunked`` from 8192 tokens).  No crossover constant
  is tuned: none has been measured on the card.
* :class:`PIMTarget` — the paper's four accelerators, priced with the
  calibrated device model exactly as the reference prices them.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

from repro_torch.pim.energy import (DESIGNS, SUBARRAY_COLS, TABLE2_AREA_MM2,
                                    TABLE2_ENERGY_SCALE, DeviceModel)
from repro_torch.pim.mapper import LayerWork, accel_cost


@dataclasses.dataclass(frozen=True)
class Cost:
    """One layer's (or model's) cost on one target."""

    energy_pj: float
    cycles: float
    bytes_moved: float

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.energy_pj + other.energy_pj,
                    self.cycles + other.cycles,
                    self.bytes_moved + other.bytes_moved)


@dataclasses.dataclass(frozen=True)
class LayerGeometry:
    """The GEMM view of one layer: (m, k) x (k, n); m is per image."""

    m: int
    k: int
    n: int

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


# ---------------------------------------------------------------------------
# Compute target: the H100
# ---------------------------------------------------------------------------

IMPLICIT_STRIDES = (1, 2)
IMPLICIT_AMP_MIN = 4.0
IMPLICIT_PADDINGS = ("SAME", "VALID")
# the TPU routing's depth threshold, kept until H100 rows exist
IMPLICIT_KDIM_MIN = 512
# the TPU table's attention crossovers (targets.py attn_flash_seq_min,
# attn_chunk_seq_min), kept until H100 rows exist
ATTN_FLASH_SEQ_MIN = 2048
ATTN_CHUNK_SEQ_MIN = 8192

# NVIDIA H100 80GB HBM3 (SXM) data-sheet figures at its 700 W limit: the
# boost clock, the dense int8 tensor-core peak and the HBM3 rate.  The
# per-op and per-byte energies are ceilings derived from them (the whole
# board's power spent on that one resource at its peak rate), not
# measurements: plan annotations only, never read by a serving decision.
H100_CLOCK_GHZ = 1.98
H100_INT8_OPS_PER_S = 1.979e15
H100_BYTES_PER_S = 3.35e12
H100_POWER_W = 700.0


def _implicit_eligible(conv) -> bool:
    return (conv is not None and conv.kh * conv.kw > 1
            and conv.stride in IMPLICIT_STRIDES
            and conv.padding in IMPLICIT_PADDINGS
            # full-window FC-as-conv layers (amplification 1) stay on the
            # dense fused GEMM
            and conv.read_amplification >= IMPLICIT_AMP_MIN)


@dataclasses.dataclass(frozen=True)
class ComputeTarget:
    """A serve backend and its engine dispatch table.  NVIDIA H100: the
    fused level-GEMM kernel by default; deep-K spatial convs take the
    implicit-GEMM kernel while one block's staged rows fit shared memory."""

    name: str = "cuda"
    kind: str = dataclasses.field(default="compute", init=False)
    clock_ghz: float = H100_CLOCK_GHZ
    flops_per_cycle: float = H100_INT8_OPS_PER_S / (H100_CLOCK_GHZ * 1e9)
    bytes_per_cycle: float = H100_BYTES_PER_S / (H100_CLOCK_GHZ * 1e9)
    pj_per_flop: float = H100_POWER_W / H100_INT8_OPS_PER_S * 1e12
    pj_per_byte: float = H100_POWER_W / H100_BYTES_PER_S * 1e12

    def cost(self, geom: LayerGeometry, a_bits: int, w_bits: int) -> Cost:
        """The reference's roofline estimate: compute-bound vs
        bandwidth-bound cycles, energy per op plus per byte."""
        itemsize = 1 if max(a_bits, w_bits) <= 7 else 4
        flops = 2.0 * geom.macs
        bytes_moved = float(itemsize * (geom.m * geom.k + geom.k * geom.n)
                            + 4 * geom.m * geom.n)
        cycles = max(flops / self.flops_per_cycle,
                     bytes_moved / self.bytes_per_cycle)
        return Cost(energy_pj=flops * self.pj_per_flop
                    + bytes_moved * self.pj_per_byte,
                    cycles=cycles, bytes_moved=bytes_moved)

    def implicit_smem(self, conv, k: int, n: int) -> tuple[int, int]:
        """(bytes one implicit-kernel block needs, the budget): the kernel
        wrapper's own layout and limit for ``n`` output channels."""
        from repro_torch.kernels.conv_implicit import SMEM_LIMIT, smem_layout

        cin = k // max(conv.kh * conv.kw, 1)
        need = smem_layout(conv.h, conv.w, cin, conv.kh, conv.kw,
                           conv.stride, conv.padding, conv.batch,
                           n).smem_bytes
        return need, SMEM_LIMIT

    def select_engine(self, m, k, n, a_bits, w_bits, conv=None) -> str:
        if _implicit_eligible(conv) and k >= IMPLICIT_KDIM_MIN:
            need, budget = self.implicit_smem(conv, k, n)
            if need <= budget:
                return "implicit"
        return "fused"

    def attn_cost(self, attn) -> Cost:
        """The reference's roofline estimate of one attention layer (plan
        annotation): scores and weighted values, two GEMMs over the
        effective KV extent (a window bounds it, causal halves it)."""
        if attn.window:
            eff_kv = min(attn.window, attn.seq_kv)
        elif attn.causal and attn.seq_q == attn.seq_kv:
            eff_kv = max(attn.seq_kv // 2, 1)
        else:
            eff_kv = attn.seq_kv
        qk = self.cost(LayerGeometry(m=attn.batch * attn.heads * attn.seq_q,
                                     k=attn.head_dim, n=eff_kv), 8, 8)
        return qk + qk

    def select_attn_engine(self, attn) -> str:
        """The reference's attention decision procedure over the TPU
        table's constants: ``paged`` for page-table geometries, ``flash``
        for quantized prefill of at least ATTN_FLASH_SEQ_MIN tokens,
        ``banded`` for a window shorter than half the queries, ``chunked``
        from ATTN_CHUNK_SEQ_MIN tokens, else ``full``."""
        from repro_torch.kernels.attn_flash import flash_levels_exact

        if attn.page_size:
            return "paged"
        seq = max(attn.seq_q, attn.seq_kv)
        if (attn.quantized and seq >= ATTN_FLASH_SEQ_MIN and attn.seq_q > 1
                and flash_levels_exact(attn.head_dim, 8, 8)):
            return "flash"
        if attn.window and attn.banded_ok and attn.seq_q > 2 * attn.window:
            return "banded"
        if seq >= ATTN_CHUNK_SEQ_MIN:
            return "chunked"
        return "full"


# ---------------------------------------------------------------------------
# PIM targets: the paper's accelerator designs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PIMTarget:
    """One of the paper's accelerators, priced with the calibrated device
    model; ``report()`` reproduces the reference's arithmetic exactly."""

    name: str = "sot_mram"
    kind: str = dataclasses.field(default="pim", init=False)
    device: DeviceModel = None
    energy_scale: float = 1.0
    area_mm2: float = 0.0

    def work(self, geom: LayerGeometry, a_bits: int, w_bits: int) -> LayerWork:
        bitp = geom.macs * a_bits * w_bits
        return LayerWork(macs=geom.macs, bit_products=bitp,
                         row_ops=-(-bitp // SUBARRAY_COLS))

    def cost(self, geom: LayerGeometry, a_bits: int, w_bits: int) -> Cost:
        w = self.work(geom, a_bits, w_bits)
        d = self.device
        if d.e_mac_asic:  # CMOS ASIC path: MAC array + eDRAM traffic
            cycles = w.macs / max(d.c_macs_per_cycle, 1)
            energy = w.macs * d.e_mac_asic + cycles * d.e_static_per_cycle
        else:
            per_row = d.c_and + d.c_write + d.c_cmp + d.c_accum
            cycles = w.row_ops * per_row / max(d.n_parallel_subarrays, 1)
            energy = w.row_ops * (d.e_and_row + d.e_write_row + d.e_cmp_row
                                  + d.e_accum) + cycles * d.e_static_per_cycle
        return Cost(energy_pj=energy * self.energy_scale, cycles=cycles,
                    bytes_moved=w.row_ops * 2 * SUBARRAY_COLS / 8)

    def report(self, works: Sequence[LayerWork]) -> dict:
        """Whole-model cost: one ``accel_cost`` over all works (summation
        order is part of the contract), then the fitted energy scale."""
        r = accel_cost(self.device, works)
        r["energy_uj"] *= self.energy_scale
        r["area_mm2"] = self.area_mm2
        r["fps_per_mm2"] = r["fps"] / self.area_mm2
        r["gops_per_w"] = (r["macs"] * 2e-9) / (r["energy_uj"] * 1e-6)
        r["eff_per_mm2"] = r["gops_per_w"] / self.area_mm2
        r["target"] = self.name
        return r


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

Target = Union[ComputeTarget, PIMTarget]
_REGISTRY: dict[str, Target] = {}
_ALIASES = {"proposed": "sot_mram", "asic": "cmos_asic", "gpu": "cuda"}


def register_target(target: Target) -> Target:
    _REGISTRY[target.name] = target
    return target


def available_targets() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_target(name: str) -> Target:
    """Resolve a target by name; unknown names raise a ValueError listing
    every registered target."""
    key = _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown hardware target {name!r}; available targets: "
            f"{', '.join(available_targets())}") from None


def target_for_backend(backend: str) -> ComputeTarget:
    """The compute target named ``backend``; any name without a compute
    target of its own gets ``cuda``'s (the port's only serve backend)."""
    t = _REGISTRY.get(_ALIASES.get(backend, backend))
    return t if isinstance(t, ComputeTarget) else _REGISTRY["cuda"]


CUDA = register_target(ComputeTarget())
SOT_MRAM = register_target(PIMTarget(
    name="sot_mram", device=DESIGNS["proposed"],
    energy_scale=TABLE2_ENERGY_SCALE["proposed"],
    area_mm2=TABLE2_AREA_MM2["proposed"]))
IMCE = register_target(PIMTarget(
    name="imce", device=DESIGNS["imce"],
    energy_scale=TABLE2_ENERGY_SCALE["imce"],
    area_mm2=TABLE2_AREA_MM2["imce"]))
RERAM = register_target(PIMTarget(
    name="reram", device=DESIGNS["reram"],
    energy_scale=TABLE2_ENERGY_SCALE["reram"],
    area_mm2=TABLE2_AREA_MM2["reram"]))
CMOS_ASIC = register_target(PIMTarget(
    name="cmos_asic", device=DESIGNS["asic"],
    energy_scale=TABLE2_ENERGY_SCALE["asic"],
    area_mm2=TABLE2_AREA_MM2["asic"]))

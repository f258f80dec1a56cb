"""4:2 compressor-tree model (paper §II-B1, Fig. 5) and the ASR / NV-FA
cycle arithmetic (port of ``repro/core/compressor.py``, a copy: the port
imports nothing of the reference).

The port does not execute compressors (a tensor core's adder tree
subsumes them), but the PIM cost model needs their cycle structure, and
the intermittency model needs the NV-FA's vulnerable window.
"""
from __future__ import annotations

import dataclasses
import math


def compressor_outputs(x1: int, x2: int, x3: int, x4: int, cin: int):
    """Golden 4:2 compressor truth function (paper Eq. 2).

    Returns (sum, carry, cout) with x1+x2+x3+x4+cin == sum + 2*(carry+cout).
    """
    xor4 = x1 ^ x2 ^ x3 ^ x4
    s = xor4 ^ cin
    carry = (xor4 & cin) | ((1 - xor4) & x4)
    cout = ((x1 ^ x2) & x3) | ((1 - (x1 ^ x2)) & x1)
    return s, carry, cout


def compress_vector(bits: list[int]) -> int:
    """Count ones via a 4:2 compressor tree (the golden model)."""
    return sum(bits)


def tree_depth(n_inputs: int) -> int:
    """Levels of 4:2 compressors to reduce n partial products to 2."""
    levels = 0
    n = n_inputs
    while n > 2:
        n = math.ceil(n / 2)  # each 4:2 level halves the operand count
        levels += 1
    return levels


def serial_counter_cycles(n_inputs: int) -> int:
    """IMCE-style serial bitcount: one shift+add cycle per input bit."""
    return n_inputs


def compressor_cycles(n_inputs: int) -> int:
    """The in-memory 4:2 compressor counts a sub-array row's ones in one
    pass: one cycle for the XOR write-back plus the pipelined tree latency
    amortized to O(1) per row."""
    return 1 + tree_depth(n_inputs) // max(tree_depth(n_inputs), 1)


def asr_shift_cycles(m_bits: int, n_bits: int) -> int:
    """Adaptive shift register: shifts up to m+n-2, MUX-parallel."""
    return 1  # MUX-select, single cycle (paper Fig. 6)


@dataclasses.dataclass(frozen=True)
class NVFATiming:
    """NV-FA restore window (paper §II-B3): power loss during the final
    shift/add loses only the in-flight adds, ~ (m+n) FA delays of 58 ps."""

    fa_delay_ps: float = 58.0

    def vulnerable_window_ps(self, m_bits: int, n_bits: int) -> float:
        return (m_bits + n_bits) * self.fa_delay_ps

"""Integer interval arithmetic for the plan prover (port of
``repro/analysis/intervals.py``, its own copy: the port imports nothing of
the reference).

The abstract domain is deliberately tiny: closed integer intervals
``[lo, hi]`` with exact (arbitrary-precision) Python int endpoints, plus
the two range constructors the quantized stack actually produces —
unsigned DoReFa levels ``[0, 2^bits - 1]`` and the signed/centered
attention levels ``[-2^(bits-1), 2^(bits-1) - 1]``.  Every bound the
prover states is the interval-semantics consequence of these ranges
propagated through the kernels' integer dataflow, so a proof here is a
proof about every possible input, not a sampled check.
"""
from __future__ import annotations

import dataclasses

# Contract constants the kernels are written against: an fp32
# accumulator's exact-integer ceiling (``f32dot``, the attention plain
# versions' float score dot) and the CUDA kernels' int32 accumulators.
FP32_MANTISSA = 1 << 24       # exact-integer ceiling of an fp32 accumulator
INT32_MAX = (1 << 31) - 1     # int32 accumulator / rowsum ceiling


@dataclasses.dataclass(frozen=True)
class Interval:
    """A closed integer interval ``[lo, hi]`` (exact endpoints)."""

    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @property
    def mag(self) -> int:
        """Largest absolute value the interval contains."""
        return max(abs(self.lo), abs(self.hi))

    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def __neg__(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def __sub__(self, other: "Interval") -> "Interval":
        return self + (-other)

    def __mul__(self, other: "Interval") -> "Interval":
        c = (self.lo * other.lo, self.lo * other.hi,
             self.hi * other.lo, self.hi * other.hi)
        return Interval(min(c), max(c))

    def scale(self, n: int) -> "Interval":
        """Sum of ``n`` independent values drawn from this interval (the
        reduction axis of a dot product)."""
        n = max(int(n), 1)
        return Interval(self.lo * n, self.hi * n)

    def within(self, bound: int) -> bool:
        """Does every value fit strictly below ``bound`` in magnitude?"""
        return self.mag < bound


def level_range(bits: int) -> Interval:
    """Unsigned DoReFa level range: ``[0, 2^bits - 1]``."""
    return Interval(0, (1 << int(bits)) - 1)


def centered_range(bits: int) -> Interval:
    """Signed/centered level range (attention path, z = 2^(bits-1))."""
    z = 1 << (int(bits) - 1)
    return Interval(-z, z - 1)


def dot_range(a: Interval, w: Interval, k: int) -> Interval:
    """Accumulator range of a depth-``k`` dot of ``a``-by-``w`` products."""
    return (a * w).scale(k)

"""Bit-plane decomposition and 32-per-word packing (port of
``repro/core/bitplane.py``; paper Fig. 3).

``C_b(levels)``, the b-th bit of every element, is one plane; a plane is
packed 32 bits per word along the contraction axis, LSB first, as the
reference packs it.  The reference's words are ``uint32``; here they are
``torch.int32`` with the same bit pattern (torch's ``uint32`` supports
few ops), so a test compares them through ``.numpy().view(np.uint32)``.

Bit 31 makes an int32 word negative, and ``>>`` on a negative int32 is an
arithmetic shift, so every shift here runs on the word widened to int64
and masked to its low 32 bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LANE = 32  # bits packed per word
_LOW32 = 0xFFFFFFFF


def _axis(axis: int, ndim: int) -> int:
    return axis if axis >= 0 else ndim + axis


def _bcast(v: torch.Tensor, ndim: int, at: int) -> torch.Tensor:
    """``v`` (1-D) shaped to broadcast along dimension ``at`` of ``ndim``."""
    return v.reshape((1,) * at + (-1,) + (1,) * (ndim - at - 1))


def to_words(x: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) (int64) -> int32 words with the same low 32
    bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def from_words(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned values, int64 in [0, 2^32)."""
    return words.to(torch.int64) & _LOW32


def decompose(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer levels -> bit planes (bits, *levels.shape), {0,1} int32."""
    lv = levels.to(torch.int64)
    shifts = _bcast(torch.arange(bits, device=lv.device), lv.ndim + 1, 0)
    return ((lv[None] >> shifts) & 1).to(torch.int32)


def compose(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`decompose`: planes (bits, ...) -> int32 levels."""
    bits = planes.shape[0]
    weights = _bcast(torch.arange(bits, device=planes.device), planes.ndim, 0)
    return torch.sum(planes.to(torch.int64) << weights, dim=0).to(torch.int32)


def pad_to_lane(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero-pad ``axis`` to a multiple of 32 (zeros AND to 0: exact)."""
    axis = _axis(axis, x.ndim)
    pad = (-x.shape[axis]) % LANE
    if pad == 0:
        return x
    # F.pad lists (left, right) pairs from the last dimension backwards
    return F.pad(x, (0, 0) * (x.ndim - axis - 1) + (0, pad))


def pack_bits(plane: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a {0,1} plane 32 per word along ``axis``, LSB first: shape
    (..., K, ...) -> (..., K/32, ...) int32 words.  K must be a multiple
    of 32 (:func:`pad_to_lane` first)."""
    axis = _axis(axis, plane.ndim)
    k = plane.shape[axis]
    if k % LANE:
        raise ValueError(f"pack_bits: K={k} is not a multiple of {LANE}")
    shape = plane.shape[:axis] + (k // LANE, LANE) + plane.shape[axis + 1:]
    x = plane.to(torch.int64).reshape(shape)
    shifts = _bcast(torch.arange(LANE, device=x.device), x.ndim, axis + 1)
    return to_words(torch.sum(x << shifts, dim=axis + 1))


def unpack_bits(packed: torch.Tensor, axis: int = -1,
                k: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> {0,1} int32; optionally truncated to
    the original K."""
    axis = _axis(axis, packed.ndim)
    x = from_words(packed).unsqueeze(axis + 1)
    shifts = _bcast(torch.arange(LANE, device=x.device), x.ndim, axis + 1)
    bits = (x >> shifts) & 1
    shape = (packed.shape[:axis] + (packed.shape[axis] * LANE,)
             + packed.shape[axis + 1:])
    out = bits.reshape(shape).to(torch.int32)
    if k is not None:
        out = out.narrow(axis, 0, k)
    return out


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit words -> int32 (the paper's CMP unit).
    torch has no popcount op: this is the SWAR bit count on the word
    widened to int64."""
    v = from_words(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & _LOW32) >> 24).to(torch.int32)


def decompose_packed(levels: torch.Tensor, bits: int,
                     axis: int = -1) -> torch.Tensor:
    """levels -> (bits, ...) planes packed along ``axis`` (padded)."""
    planes = decompose(pad_to_lane(levels, axis), bits)
    return pack_bits(planes, axis=(axis if axis < 0 else axis + 1))

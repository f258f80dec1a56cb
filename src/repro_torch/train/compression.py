"""Gradient compression (port of ``repro/train/compression.py``): int8
levels with a per-leaf absmax scale and an error-feedback residual, so
the quantization error telescopes instead of accumulating.

:func:`compressed_allreduce` with no group is the reference's
``axis_name=None`` path (compression models the wire format, nothing is
exchanged; on a trainer's DTensors, DTensor owns the collectives); with a
``torch.distributed`` process group it is the reference's ``axis_name``
path: the mean over the group's ranks of their decompressed gradients,
with the int8 levels and the float32 scale of every leaf as the only
traffic (all-gathered, then dequantized and summed in rank order on every
rank).  The error-feedback residual stays local.
"""
from __future__ import annotations

import torch

from .optimizer import tree_leaves, tree_map, tree_unflatten


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros_like(p, requires_grad=False),
                    params)


def compress(g: torch.Tensor, bits: int = 8):
    """g -> (levels int8, scale float32 0-d): symmetric absmax levels in
    [-(2^(b-1) - 1), 2^(b-1) - 1]."""
    z = float(1 << (bits - 1)) - 1
    scale = torch.max(torch.abs(g)) / z + 1e-12
    levels = torch.clamp(torch.round(g / scale), -z, z).to(torch.int8)
    return levels, scale.to(torch.float32)


def decompress(levels: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return levels.to(dtype) * scale


@torch.no_grad()
def compressed_allreduce(grads, ef_state, group=None, bits: int = 8):
    """Error-feedback compressed mean-all-reduce -> ``(new_grads,
    new_ef_state)``: each leaf's ``g + e`` is compressed, the new residual
    is what the local decompression lost, and with ``group`` the new
    gradient is the group mean of every rank's decompressed leaf."""
    def one(g, e):
        corrected = g + e
        lv, sc = compress(corrected, bits)
        deq = decompress(lv, sc, g.dtype)
        new_e = corrected - deq
        if group is not None:
            deq = _mean_over(group, lv, sc, g.dtype)
        return deq, new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(ef_state))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def _mean_over(group, levels: torch.Tensor, scale: torch.Tensor,
               dtype) -> torch.Tensor:
    """The group mean of every rank's ``decompress(levels, scale)``, from
    the int8 levels and float32 scales alone (all-gathered), summed in
    rank order."""
    dist = torch.distributed
    n = dist.get_world_size(group)
    lvs = [torch.empty_like(levels) for _ in range(n)]
    scs = [torch.empty(1, dtype=torch.float32, device=scale.device)
           for _ in range(n)]
    dist.all_gather(lvs, levels.contiguous(), group=group)
    dist.all_gather(scs, scale.reshape(1), group=group)
    total = decompress(lvs[0], scs[0][0], dtype)
    for lv, sc in zip(lvs[1:], scs[1:]):
        total = total + decompress(lv, sc[0], dtype)
    return total / n


def compression_ratio(params, bits: int = 8) -> float:
    leaves = tree_leaves(params)
    fp_bytes = sum(x.numel() * 4 for x in leaves)
    q_bytes = sum(x.numel() * bits / 8 + 4 for x in leaves)
    return fp_bytes / q_bytes

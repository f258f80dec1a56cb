"""Gradient compression (port of ``repro/train/compression.py``): int8
levels with a per-leaf absmax scale and an error-feedback residual, so
the quantization error telescopes instead of accumulating.

This port runs on one device: :func:`compressed_allreduce` takes the
local path only (the reference's ``axis_name=None``: compression models
the wire format, nothing is exchanged).  The all-reduce over a process
group comes with the distributed slice; passing a group raises.
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
    """Error-feedback compression of every gradient leaf -> ``(new_grads,
    new_ef_state)``: each leaf's ``g + e`` is compressed and decompressed,
    and the new residual is what that lost."""
    if group is not None:
        raise NotImplementedError(
            "compressed_allreduce over a process group comes with the "
            "distributed slice (distributed/sharding); this port trains on "
            "one device")

    def one(g, e):
        corrected = g + e
        lv, sc = compress(corrected, bits)
        deq = decompress(lv, sc, g.dtype)
        return deq, corrected - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(ef_state))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def compression_ratio(params, bits: int = 8) -> float:
    leaves = tree_leaves(params)
    fp_bytes = sum(x.numel() * 4 for x in leaves)
    q_bytes = sum(x.numel() * bits / 8 + 4 for x in leaves)
    return fp_bytes / q_bytes

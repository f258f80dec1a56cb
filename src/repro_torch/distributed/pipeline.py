"""GPipe pipeline parallelism over ``torch.distributed`` point-to-point
(port of ``repro/distributed/pipeline.py``).

An optional axis: ``make_pipeline_mesh(stages, data)`` builds a
``("pipe", "data")`` ``DeviceMesh`` and :func:`pipeline_apply` runs a
stage-partitioned layer stack over it with the GPipe fill-drain
schedule: at tick ``t`` of ``M + S - 1``, stage ``s`` runs microbatch
``t - s``, and activations pass ``s -> s+1`` by ``batch_isend_irecv``
over the rank's ``pipe`` group.  The result is differentiable with
respect to the stage params: the backward of each pass sends the
gradient ``s+1 -> s``.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_pipeline_mesh(stages: int, data: int = 1,
                       device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (stages, data),
                            mesh_dim_names=("pipe", "data"))


def _exchange(send: torch.Tensor | None, to: int | None,
              frm: int | None, like: torch.Tensor) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` and receive a tensor shaped
    like ``like`` from ``frm`` (zeros where there is no peer)."""
    dist = torch.distributed
    got = torch.zeros_like(like)
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, got, frm))
    for w in (dist.batch_isend_irecv(ops) if ops else ()):
        w.wait()
    return got


class _Shift(torch.autograd.Function):
    """Forward: this stage's output to the next stage, the previous
    stage's output in.  Backward: the transpose (gradients ``s+1 -> s``)."""

    @staticmethod
    def forward(ctx, out, nxt, prev):
        ctx.nxt, ctx.prev = nxt, prev
        return _exchange(out, nxt, prev, out)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prev, ctx.nxt, g), None, None


class _FromLast(torch.autograd.Function):
    """Forward: the last stage's tensor on every pipe rank (a broadcast
    over the pipe group: the reference's masked ``psum``).  Backward: the
    output is the same on every rank, so its one cotangent goes to the
    last stage and the others get zeros."""

    @staticmethod
    def forward(ctx, x, src, group, is_last):
        ctx.is_last = is_last
        y = x.clone()
        torch.distributed.broadcast(y, src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros_like(g)), None, None, None


def pipeline_apply(stage_fn: Callable, stage_params, x, *, mesh,
                   n_microbatches: int):
    """``y = stage_S(...stage_1(x))`` over the mesh's ``pipe`` axis.

    ``stage_params``: a tree of DTensors with a leading stage axis, placed
    ``Shard(0)`` over ``pipe`` and ``Replicate()`` over ``data`` (each
    rank holds its stage's slice).  ``x``: ``(M, mb, ...)`` microbatch-
    major activations, a DTensor placed ``Replicate()`` over ``pipe`` and
    ``Shard(1)`` over ``data``.  Returns ``y`` placed as ``x``.  Each
    rank runs ``stage_fn(params, inp)`` on its local slices (the
    reference's ``shard_map``); a stage param's gradient is ``Partial``
    over ``data`` (each data rank's microbatch rows contribute).
    Schedule: GPipe fill-drain of ``T = M + S - 1`` ticks; the bubble
    fraction is ``(S-1)/(M+S-1)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.train.optimizer import tree_map

    S, M = mesh.shape[0], n_microbatches
    s, d = mesh.get_coordinate()
    ranks = mesh.mesh
    nxt = int(ranks[s + 1, d]) if s + 1 < S else None
    prev = int(ranks[s - 1, d]) if s > 0 else None
    params = tree_map(
        lambda p: p.to_local(grad_placements=[Shard(0), Partial()])[0],
        stage_params)
    xs = x.to_local()
    if xs.shape[0] != M:
        raise ValueError(f"x has {xs.shape[0]} microbatches, expected {M}")
    zeros = torch.zeros_like(xs[0])
    # every stage feeds through ``where`` (stage 0 takes the microbatch,
    # the others what came in), so each pass's output reaches the graph on
    # every rank and every rank runs each pass's backward exchange
    first = torch.tensor(s == 0, device=xs.device)
    buf, outs = zeros, [None] * M
    for t in range(M + S - 1):
        feed = xs[t] if t < M else zeros
        out = stage_fn(params, torch.where(first, feed, buf))
        buf = _Shift.apply(out, nxt, prev)
        if t >= S - 1:
            outs[t - (S - 1)] = out
    ys = _FromLast.apply(torch.stack(outs), int(ranks[S - 1, d]),
                         mesh.get_group("pipe"), s == S - 1)
    return DTensor.from_local(ys, mesh, [Replicate(), Shard(1)],
                              run_check=False)


def bubble_fraction(n_microbatches: int, stages: int) -> float:
    return (stages - 1) / (n_microbatches + stages - 1)

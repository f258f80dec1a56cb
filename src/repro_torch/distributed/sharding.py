"""Logical-axis sharding (port of ``repro/distributed/sharding.py``):
(axes tree, ShardPlan, mesh) -> per-leaf specs and DTensor placements.

Rules:
  vocab      -> model     (unembed column parallel; vocab padded to %256)
  heads      -> model     (Q heads padded to a TP multiple, zero-masked)
  kv_heads   -> model IF n_kv % tp == 0 else replicated
  mlp        -> model     (column/row parallel FFN)
  expert     -> model IF n_experts % tp == 0 else replicated
  embed      -> data      (FSDP/ZeRO param sharding)
  batch      -> (pod, data)
  cache_seq  -> model
  vocab_in   -> replicated (embedding table gather stays local)

Every mapping is divisibility-guarded against the actual dim, so odd
sizes degrade to replication.

A *spec* is the port's ``PartitionSpec``: a tuple with one entry per
tensor dim, each a mesh-axis name, a tuple of names (the dim split over
those mesh axes, major first) or ``None`` (not split); ``()`` is
replicated.  A *sharding* is the DTensor form of a spec on a
``DeviceMesh``: one placement per mesh dim, ``Shard(d)`` where the spec
puts that mesh axis on tensor dim ``d``, else ``Replicate()``.  A mesh
here is a ``torch.distributed.device_mesh.DeviceMesh`` or anything with
a ``.shape`` dict ``{axis: size}`` (the specs need only the sizes).

The reference's ``mesh_context`` has no counterpart: a ``DeviceMesh`` is
passed explicitly wherever it is used.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (or of a ``.shape`` dict)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _batch_entry(plan) -> Optional[Any]:
    """The batch axes as one spec entry (a lone axis by its name, as
    ``PartitionSpec`` normalizes a 1-tuple)."""
    bax = tuple(plan.batch_axes)
    if not bax:
        return None
    return bax[0] if len(bax) == 1 else bax


def _resolve(logical: Optional[str], plan, cfg) -> Optional[Any]:
    if logical is None:
        return None
    if logical == "batch":
        return _batch_entry(plan)
    if logical == "vocab_in":
        return None
    if logical == "kv_heads":
        return "model" if (cfg is not None
                           and plan.shard_kv(cfg.n_kv_heads)) else None
    if logical == "expert":
        return "model" if (cfg is not None
                           and plan.shard_experts(cfg.n_experts)) else None
    if logical == "cache_seq":
        return "model"
    return plan.axis_for(logical)


def _axis_size(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes[a]
    return n


def pspec_for(shape, axes, plan, mesh, cfg=None) -> tuple:
    """The spec of one array, with the divisibility and duplicate-axis
    guards: a dim whose mesh axes an earlier dim took, or whose size the
    axes' product does not divide, stays unsplit."""
    if axes is None:
        return ()
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} vs shape {tuple(shape)}")
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dim, logical in zip(shape, axes):
        entry = _resolve(logical, plan, cfg)
        if entry is None:
            out.append(None)
            continue
        flat = entry if isinstance(entry, tuple) else (entry,)
        if any(a in used for a in flat) or dim % _axis_size(sizes, entry):
            out.append(None)
            continue
        used.update(flat)
        out.append(entry)
    return tuple(out)


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` if the spec splits tensor dim ``d`` over it and the mesh
    dim has more than one rank (a split one way is no split, and DTensor
    refuses some views of a dim marked split even then)."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple)
                  else (() if entry is None else (entry,))):
            where[a] = d
    return tuple(Shard(where[a]) if a in where and n > 1 else Replicate()
                 for a, n in mesh_sizes(mesh).items())


def _walk2(fn: Callable, tree, axes_tree):
    """``fn(leaf, axes)`` over two trees in lockstep (axes leaves are
    tuples or None)."""
    if isinstance(tree, dict):
        return {k: _walk2(fn, tree[k], axes_tree[k]) for k in tree}
    if isinstance(tree, list):
        return [_walk2(fn, t, a) for t, a in zip(tree, axes_tree)]
    if (isinstance(axes_tree, tuple) or axes_tree is None) \
            and hasattr(tree, "shape"):
        return fn(tree, axes_tree)
    raise TypeError(f"mismatched trees: {type(tree)} vs {type(axes_tree)}")


def tree_specs(tree, axes_tree, plan, mesh, cfg=None):
    """The spec of every leaf of ``tree`` (tensors, or anything with a
    ``.shape``)."""
    return _walk2(lambda x, ax: pspec_for(tuple(x.shape), ax, plan, mesh,
                                          cfg), tree, axes_tree)


def tree_shardings(tree, axes_tree, plan, mesh, cfg=None):
    """The DTensor placements of every leaf of ``tree`` on ``mesh``."""
    return _map(lambda spec: placements_for(spec, mesh),
                tree_specs(tree, axes_tree, plan, mesh, cfg))


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _zip_map(fn: Callable, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, list):
        return [_zip_map(fn, t, o) for t, o in zip(tree, other)]
    return fn(tree, other)


def distribute_tree(tree, shardings, mesh):
    """Place every leaf of ``tree`` (full tensors, the same on every rank)
    as a DTensor with its placements from ``shardings`` (the tree of
    placement tuples :func:`tree_shardings` or :func:`batch_shardings`
    gives).  Each rank keeps its own slice, on the mesh's device; a meta
    tensor (the dry run's abstract arguments) stays on the meta device."""
    from torch.distributed.tensor import distribute_tensor

    dev = local_device(mesh)
    return _zip_map(lambda x, pl: distribute_tensor(
        x.detach() if x.is_meta else x.detach().to(dev), mesh, list(pl)),
        tree, shardings)


def local_device(mesh) -> torch.device:
    """This rank's device on the mesh: the CPU, or the current card (the
    launcher sets it to the rank's local index)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def full_tree(tree):
    """Every DTensor leaf gathered to its full tensor on its rank's device
    (other leaves unchanged)."""
    from torch.distributed.tensor import DTensor

    return _map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x,
                tree)


DATA_AXES = ("pod", "data")


def at_use(tree, mesh):
    """Params as a step computes with them: every DTensor leaf's
    data-parallel mesh axes (``pod``, ``data``: the FSDP/ZeRO storage
    split) all-gathered to ``Replicate()``, its ``model`` axis kept split.
    Differentiable: the backward reduce-scatters each gradient back to
    the storage placements.  This is the reference's "XLA all-gathers per
    use" made explicit: left to itself, DTensor contracts a batch-split
    activation with a weight split on the same mesh axis along its input
    dim into ``Partial`` sums, which reorders every projection's
    reduction."""
    from torch.distributed.tensor import DTensor, Replicate

    names = tuple(mesh_sizes(mesh))

    def one(p):
        if not isinstance(p, DTensor):
            return p
        pl = tuple(Replicate() if n in DATA_AXES else q
                   for n, q in zip(names, p.placements))
        return p if pl == tuple(p.placements) else p.redistribute(mesh, pl)

    return _map(one, tree)


def whole_dim(t, dim: int):
    """``t`` with tensor dim ``dim`` gathered (``Replicate()`` where a
    mesh dim splits it) if ``t`` is a DTensor; other tensors unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    d = dim % t.ndim
    pl = tuple(Replicate() if isinstance(q, Shard) and q.dim % t.ndim == d
               else q for q in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def per_head(core: Callable, q, k, v, expand: Callable):
    """Attention's core, ``core(q, *expand(k, v))``, with the heads on dim
    2 and the batch on dim 0.  On DTensors (a train step on a mesh) ``k``
    and ``v`` are gathered over their heads (:func:`whole_dim`: few, for
    GQA) and expanded to ``q``'s heads, and ``core`` runs on each rank's
    own slice: ``q``'s split of the batch (dim 0) and of the heads (dim 2)
    kept, any other mesh dim replicated, ``k`` and ``v`` sliced to match
    (no communication).  Attention is independent per batch row and per
    head, so this is exact; the output is a DTensor in those placements,
    and its gradient flows back through the same slices.  Plain tensors
    run ``core`` as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor):
        return core(q, *expand(k, v))
    k, v = expand(whole_dim(k, 2), whole_dim(v, 2))
    mesh = q.device_mesh
    pl = tuple(x if isinstance(x, Shard) and x.dim % q.ndim in (0, 2)
               else Replicate() for x in q.placements)
    q, k, v = (t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
               for t in (q, k, v))
    out = core(q.to_local(), k.to_local(), v.to_local())
    return DTensor.from_local(out, mesh, pl, run_check=False)


def on_mesh():
    """The context a step on DTensors runs in: a plain tensor the model
    makes inside the step (rotary tables, masks, positions, the zero aux
    loss) meets the DTensors as ``Replicate()`` on every mesh dim
    (DTensor's ``implicit_replication``); every such tensor is the same on
    every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh_sizes(mesh))


def batch_sharding(mesh, axis: str = "data") -> tuple:
    """Placements for a dim-0-batched array split over ``axis``."""
    return placements_for((axis,), mesh)


def split_batch(batch: torch.Tensor, mesh: Sequence) -> list:
    """Dim 0 of ``batch`` split evenly over the devices of a data mesh, in
    order, each shard copied to its device (``non_blocking``: from a
    pinned host batch the copies overlap compute)."""
    n = len(mesh)
    if batch.shape[0] % n:
        raise ValueError(f"batch {batch.shape[0]} is not divisible by "
                         f"{n} devices")
    return [shard.to(torch.device(dev), non_blocking=True)
            for dev, shard in zip(mesh, batch.chunk(n, dim=0))]


def data_parallel(fn: Callable, mesh: Sequence) -> Callable:
    """The serving layout over a data mesh (a sequence of devices, one
    per replica): ``fn(params, batch, *args) -> out`` becomes
    ``g(replicas, batch, *args)``, ``replicas`` holding the params once a
    device (replicated), dim 0 of ``batch`` split evenly over the devices
    in order (:func:`split_batch`; or ``batch`` already a list of such
    shards), each shard run on its device as its own call of ``fn`` (so
    per-tensor reductions, such as activation scales, see that shard
    alone, as under the reference's ``shard_map``), the outputs
    concatenated in order on the first device.

    ``fn`` must be per-sample independent, and dim 0 divisible by the
    device count (the serving engine's padding guarantees it)."""
    devices = [torch.device(d) for d in mesh]

    def run(replicas, batch, *args) -> torch.Tensor:
        shards = (split_batch(batch, devices) if torch.is_tensor(batch)
                  else batch)
        outs = []
        for params, dev, shard in zip(replicas, devices, shards):
            with _on(dev):
                outs.append(fn(params, shard, *args))
        return torch.cat([o.to(devices[0], non_blocking=True)
                          for o in outs], dim=0)

    return run


def _on(dev: torch.device):
    """``torch.cuda.device(dev)`` for a card, else nothing."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def batch_pspec(plan, ndim: int, batch_dim: int = 0) -> tuple:
    spec = [None] * ndim
    spec[batch_dim] = _batch_entry(plan)
    return tuple(spec)


def batch_spec(shape, plan, mesh) -> tuple:
    """Dim 0 split over the batch axes (divisibility-guarded), else
    replicated."""
    bax = _batch_entry(plan)
    if bax is None or len(shape) == 0 \
            or shape[0] % _axis_size(mesh_sizes(mesh), bax):
        return ()
    return (bax,) + (None,) * (len(shape) - 1)


def batch_shardings(batch_tree, plan, mesh):
    """Placements splitting dim 0 of every leaf over the batch axes."""
    return _map(lambda x: placements_for(
        batch_spec(tuple(x.shape), plan, mesh), mesh), batch_tree)

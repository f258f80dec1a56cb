"""Elastic scaling and straggler mitigation (port of
``repro/train/elastic.py``).

Checkpoint-mediated elasticity: shardings are functions of the mesh
(``distributed.sharding``), so growing or shrinking the job is: drain ->
full checkpoint -> rebuild mesh and plan -> re-place the params under the
new shardings -> resume at the same step with the same data cursor (the
pipeline addresses batches by (step, micro), not by wall clock).  A mesh
here is a ``DeviceMesh`` over the same ``torch.distributed`` world.

Straggler policy: deterministic data reassignment: every host can compute
any other host's shard from (step, host), so a backup host can shadow a
straggler's microbatch without coordination.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import make_plan
from repro_torch.distributed import sharding as shd


@dataclasses.dataclass
class ElasticState:
    mesh: Any
    plan: Any


def build(mesh) -> ElasticState:
    return ElasticState(mesh=mesh, plan=make_plan(shd.mesh_sizes(mesh)))


def remesh(params, param_axes, cfg, old: ElasticState, new_mesh
           ) -> tuple[Any, ElasticState]:
    """Re-place a param tree (DTensors on ``old.mesh``) under
    ``new_mesh``'s shardings, through full arrays -> ``(params, state)``.
    Every rank calls it together (the gathers are collectives)."""
    new = build(new_mesh)
    full = shd.full_tree(params)
    sh = shd.tree_shardings(full, param_axes, new.plan, new_mesh, cfg)
    return shd.distribute_tree(full, sh, new_mesh), new


def shard_assignment(n_hosts: int, step: int, micro: int,
                     global_batch: int) -> list[tuple[int, int]]:
    """Deterministic (host -> batch-slice) map; any host can recompute any
    other host's slice.  Rotated each step so a persistently slow host
    does not starve the same data shard."""
    per = global_batch // n_hosts
    rot = (step + micro) % n_hosts
    return [((h + rot) % n_hosts, h * per) for h in range(n_hosts)]


def straggler_backup(host: int, n_hosts: int, step: int, micro: int) -> int:
    """Which host shadows ``host`` this microbatch (ring neighbour)."""
    if n_hosts <= 1:
        return host
    return (host + 1 + (step + micro) % (n_hosts - 1)) % n_hosts

"""Device meshes (port of ``repro/launch/mesh.py``).

Functions, not module-level constants, so importing this module never
touches device or process-group state.  The training meshes are
``DeviceMesh``es over the initialized ``torch.distributed`` world (one
rank per device); the serving mesh is the list of devices the serving
engine holds a replica on.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import mesh_sizes


def _world() -> int:
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``("data", "model")`` 16 x 16 mesh, or ``("pod",
    "data", "model")`` 2 x 16 x 16; raises when the world is smaller than
    the 256 or 512 ranks it needs."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    if _world() != need:
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{need} ranks; this one has {_world()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_shape_dict(mesh) -> dict:
    return mesh_sizes(mesh)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over the current world: ``model``-way
    tensor parallel, the rest data parallel."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world()
    if n % model:
        raise ValueError(f"model={model} does not divide a world of {n}")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_serve_mesh(data: int | None = None, device_type: str = "cuda"):
    """The serving engine's data mesh: the devices ``cuda:0 .. n-1`` (all
    visible cards, or ``data``), or ``None`` on one device, where the
    engine runs its single-device path.  The engine holds one replica of
    the params on each device and splits every bucket over them."""
    if device_type == "cpu":
        n = data or 1
        return None if n <= 1 else tuple(torch.device("cpu")
                                         for _ in range(n))
    n = data or torch.cuda.device_count()
    if n <= 1:
        return None
    return tuple(torch.device("cuda", i) for i in range(n))

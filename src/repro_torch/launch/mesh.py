"""Device meshes of the port (the JAX package's ``launch/mesh.py``).

Defined as functions, never module-level constants, so that importing this
module touches no process group: the dry-run builds a fake group of 256 or
512 ranks first, and the tests see a single process.

The production mesh is sized for H100 nodes, not for the TPU pod slice the
JAX package targets ((data=16, model=16) there).  An H100 node joins 8 cards
all to all by NVLink; a tensor-parallel axis of 16 would cross InfiniBand
between nodes at every layer.  So the model axis is 8 (one node) and the
data axis takes the rest: (data=32, model=8) is 256 cards (32 nodes), and
(pod=2, data=32, model=8) is 512, the pod axis pure data parallelism.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

PRODUCTION = {False: ((32, 8), ("data", "model")),
              True: ((2, 32, 8), ("pod", "data", "model"))}


def production_ranks(multi_pod: bool = False) -> int:
    return math.prod(PRODUCTION[multi_pod][0])


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """(data=32, model=8) = 256 cards, or with ``multi_pod`` (pod=2, data=32,
    model=8) = 512.  Needs a process group of exactly that many ranks: a
    fake group in the dry-run, or ``torchrun`` over the cluster."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != production_ranks(multi_pod):
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} needs "
                           f"{production_ranks(multi_pod)} ranks; this process group has {world}")
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device_type: str | None = None):
    """A (data, model) mesh over the ranks of the current process group.
    Without a group, one of one rank is made first (an in-process store, no
    network), so one card gives (1, 1)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    return init_device_mesh(device_type or _device_type(), (n // mp, mp),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """All pure-DP axes of a mesh (pod included when present)."""
    from repro_torch.distributed.sharding import axis_names

    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))

"""Activation sharding constraints (logical axes 'dp'/'tp'), the JAX
package's ``distributed/act_sharding.py`` over DTensors.

Model code calls ``constrain(x, 'dp', None, 'tp', None)``-style hints at
the JAX package's points (post-QKV, FFN hidden, MoE dispatch buffers...).
Inside a ``use_mesh`` scope a DTensor is redistributed to the resolved
placements; outside one, or on a plain tensor, ``x`` comes back unchanged,
so single-device code never sees a mesh.  Axes that do not divide the
corresponding dimension are dropped per dimension: the same divisibility
policy as the parameter rules.

``use_mesh`` also lets plain tensors (positions, masks, constants the model
makes as it runs) meet DTensors as if replicated
(``implicit_replication``).  Its scope is process-wide, where the JAX
package's is thread-local: PyTorch runs a CUDA backward pass, and with it
the recomputation of checkpointed layers, on its own autograd threads,
which must see the mesh the forward pass saw (MoE sizes its token groups
by ``dp_total()``).
"""
from __future__ import annotations

import contextlib
import math
import types

from repro_torch.distributed.sharding import axis_names, axis_sizes, to_placements

_STATE = types.SimpleNamespace(mesh=None, layout="tp")


def _mesh():
    return _STATE.mesh


def layout() -> str:
    return _STATE.layout


def current_mesh():
    """The mesh of the innermost ``use_mesh`` scope, or None."""
    return _mesh()


@contextlib.contextmanager
def use_mesh(mesh, layout: str = "tp"):
    from torch.distributed.tensor.experimental import implicit_replication

    prev, prev_layout = _mesh(), _STATE.layout
    _STATE.mesh = mesh
    _STATE.layout = layout
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.mesh = prev
        _STATE.layout = prev_layout


def active() -> bool:
    return _mesh() is not None


def _resolve(mesh, dim: int, ax):
    """logical 'dp'/'tp' -> mesh axes, dropped unless they divide dim."""
    lay = layout()
    names_all = axis_names(mesh)
    sizes = axis_sizes(mesh)
    if ax is None:
        return None
    if ax == "tp":
        names = (("model",) if (lay in ("tp", "serve_tp") and "model" in names_all) else ())
    elif ax == "dp":
        pool = (("pod", "data", "model") if lay == "dp_only" else ("pod", "data"))
        names = tuple(a for a in pool if a in names_all)
    else:
        names = (ax,) if ax in names_all else ()
    size = math.prod(sizes[n] for n in names)
    if not names or size == 0 or dim % size != 0:
        return None
    return names if len(names) > 1 else names[0]


def resolve(mesh, shape, spec) -> tuple:
    """A logical spec ('dp'/'tp'/None per dim) resolved on ``mesh``."""
    assert len(spec) == len(shape), f"spec rank {len(spec)} vs array rank {len(shape)}"
    return tuple(_resolve(mesh, d, a) for d, a in zip(shape, spec))


def constrain(x, *spec):
    from torch.distributed.tensor import DTensor

    mesh = _mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    # redistributed even where the placements already match: the backward
    # pass then lays the gradient out the same way, as a JAX sharding
    # constraint binds the cotangent too
    return x.redistribute(mesh, to_placements(mesh, resolve(mesh, x.shape, spec)))


def dp_total() -> int:
    """Size of the current data-parallel axis pool (1 outside a mesh scope).
    Model code uses this to pick per-shard dispatch granularity (MoE)."""
    mesh = _mesh()
    if mesh is None:
        return 1
    pool = (("pod", "data", "model") if layout() == "dp_only" else ("pod", "data"))
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in pool if a in sizes)


"""Logical-axis sharding rules for every architecture in the zoo (the JAX
package's ``distributed/sharding.py``), and their placement on a
``torch.distributed`` ``DeviceMesh`` as DTensors.

Scheme (as in the JAX package):

* 2-D weight sharding: tensor-parallel over ``model``, FSDP over ``data``
  (and ``pod`` stays pure DP).  Stacked layer axes are never sharded.
* vocab-parallel embedding/head over ``model``.
* MoE expert axis over ``model`` (+ FSDP over ``data``): expert parallelism.
* KV caches: batch over data axes; the cache *sequence* over ``model`` when
  it divides (each rank attends over its rows, ``models.layers``), else
  heads over ``model``.
* ``long_500k`` (batch 1): the cache sequence shards over ``data`` too.

The rules are pure functions of names, shapes and a mesh's axis names and
sizes.  A spec is a tuple with one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of names (major first), what a JAX ``PartitionSpec``
holds.  A mesh is a ``DeviceMesh`` (``mesh_dim_names``) or any object with
``shape`` (name -> size) and ``axis_names``, as a JAX ``Mesh`` has.
``to_placements`` turns a spec into one DTensor placement per mesh dim, and
the ``*_shardings`` functions place whole trees with ``distribute_tensor``.
"""
from __future__ import annotations

import math
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.training.tree import leaves_with_paths

Spec = tuple


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """name -> size, in mesh order."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


# ---------------------------------------------------------------------------
# Layouts: how the fixed physical mesh axes map to logical roles.
#   'tp'       - data axes = (pod, data); model axis = tensor parallel;
#                weights FSDP-sharded over data (gathered per traversal)
#   'serve_tp' - like 'tp' but weights are TP-resident ONLY (replicated over
#                the data axes): no per-step weight all-gathers
#   'dp_only'  - model axis joins the data axes (pure FSDP/DP)
# ---------------------------------------------------------------------------

LAYOUTS = ("tp", "serve_tp", "dp_only")


def dp_axes(mesh, layout: str = "tp"):
    names = ("pod", "data", "model") if layout == "dp_only" else ("pod", "data")
    axes = tuple(a for a in names if a in axis_names(mesh))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def tp_axis(mesh, layout: str = "tp"):
    if layout in ("tp", "serve_tp") and "model" in axis_names(mesh):
        return "model"
    return None


def dp_size(mesh, layout: str = "tp") -> int:
    n = _axis_size(mesh, "pod") * _axis_size(mesh, "data")
    if layout == "dp_only":
        n *= _axis_size(mesh, "model")
    return n


def _div(n: int, mesh, axis) -> bool:
    if axis is None:
        return False
    if isinstance(axis, tuple):
        return n % math.prod(_axis_size(mesh, a) for a in axis) == 0
    return n % _axis_size(mesh, axis) == 0


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

_LAST2_RULES: dict[str, tuple[Optional[str], Optional[str]]] = {
    # name -> (spec for dim -2, spec for dim -1); leading dims unsharded
    # (stacked layer axes) unless MoE handles them explicitly.
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "wq_a": ("data", None),
    "wq_b": (None, "model"),
    "wkv_a": ("data", None),
    "wk_b": (None, "model"),
    "wv_b": (None, "model"),
    "w1": ("data", "model"),
    "w3": ("data", "model"),
    "w2": ("model", "data"),
    "sw1": ("data", "model"),
    "sw3": ("data", "model"),
    "sw2": ("model", "data"),
    "wg": ("data", "model"),
    "wr": ("data", "model"),
    "wd_w1": (None, None),
    "wd_w2": (None, None),
    "tm_w1": (None, None),
    "tm_w2": (None, None),
    "w_in1": ("data", "model"),
    "w_in2": ("data", "model"),
    "w_out": ("model", "data"),
    "w_a": ("data", "model"),
    "w_x": ("data", "model"),
    "router": (None, None),
}

_VEC_MODEL = {"bq", "bk", "bv", "lam", "b_a", "b_x", "conv_b"}


def _path_names(path) -> list[str]:
    """A leaf's path as names: a '/'-joined string (``training.tree``'s
    paths) or a sequence of keys and indices."""
    if isinstance(path, str):
        return path.split("/")
    return [str(p) for p in path]


def param_spec(cfg: ModelConfig, mesh, path, leaf, layout: str = "tp") -> Spec:
    names = _path_names(path)
    name = names[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    # rule tokens -> physical axes under this layout
    if layout == "dp_only":
        fsdp = ("data", "model")
    elif layout == "serve_tp":
        fsdp = None  # weights TP-resident, replicated over data axes
    else:
        fsdp = "data"
    tp = tp_axis(mesh, layout)

    def ax(token, dim):
        a = {"data": fsdp, "model": tp}.get(token, token)
        return a if (a and _div(dim, mesh, a)) else None

    if name == "embed":  # (V, d): vocab-parallel + FSDP on d
        v_ax = ax("model", shape[0]) or ax("data", shape[0])
        d_ax = ax("data", shape[1]) if v_ax != fsdp else None
        return (v_ax, d_ax)
    if name == "lm_head":  # (d, V)
        v_ax = ax("model", shape[1]) or ax("data", shape[1])
        d_ax = ax("data", shape[0]) if v_ax != fsdp else None
        return (d_ax, v_ax)
    if name == "u":  # rwkv bonus (L, H, N)
        return (*([None] * (nd - 2)), ax("model", shape[-2]), None)

    is_moe = "ffn" in names and name in ("w1", "w2", "w3") and nd >= 3 and (
        cfg.n_experts and shape[-3] == cfg.n_experts
    )
    if is_moe:
        # (..., E, d, ff) or (..., E, ff, d): expert-parallel over model,
        # FSDP over data on the d dim
        a, b = _LAST2_RULES[name]
        lead = [None] * (nd - 3)
        spec2 = [
            ax(a, shape[-2]) if a == "data" else None,
            ax(b, shape[-1]) if b == "data" else None,
        ]
        e_ax = ax("model", cfg.n_experts) or (
            ax("data", cfg.n_experts) if layout != "tp" else None
        )
        if e_ax == fsdp:  # expert dim took the fsdp axes; drop from dims
            spec2 = [None, None]
        return (*lead, e_ax, *spec2)

    if name in _LAST2_RULES and nd >= 2:
        a, b = _LAST2_RULES[name]
        lead = [None] * (nd - 2)
        return (*lead, ax(a, shape[-2]), ax(b, shape[-1]))
    if name in _VEC_MODEL and nd >= 1:
        lead = [None] * (nd - 1)
        return (*lead, ax("model", shape[-1]))
    # norms, small loras, scalars: replicated
    return (None,) * nd


def param_specs(cfg: ModelConfig, mesh, params, layout: str = "tp") -> dict:
    """{path: spec} for every leaf of a parameter tree, in flatten order."""
    return {path: param_spec(cfg, mesh, path, leaf, layout)
            for path, leaf in leaves_with_paths(params)}


# ---------------------------------------------------------------------------
# Batch / decode-state rules
# ---------------------------------------------------------------------------


def batch_spec(cfg: ModelConfig, mesh, shape: ShapeConfig, layout: str = "tp") -> dict:
    dp = dp_axes(mesh, layout)
    sharded_b = shape.global_batch % dp_size(mesh, layout) == 0
    bax = dp if sharded_b else None
    out = {
        "tokens": (bax, None),
        "labels": (bax, None),
    }
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = (bax, None, None)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = (bax, None, None)
    return out


def tokens_spec(mesh, batch: int, layout: str = "tp") -> Spec:
    """A (B,) vector of the decode step's tokens (the dry-run's ``tok_sh``)."""
    return (dp_axes(mesh, layout) if batch % dp_size(mesh, layout) == 0 else None,)


def decode_state_spec(cfg: ModelConfig, mesh, batch: int, path, leaf,
                      layout: str = "tp") -> Spec:
    """Sharding for one leaf of the decode state (leading dim = stacked
    layers within a segment for everything except cache_len).

    Caches shard: batch -> dp axes; *sequence* -> model axis (each rank
    attends over its rows and the partial softmaxes are combined over the
    axis: the sequence-sharded flash-decoding layout).  Batch-1 long context
    additionally shards S over the data axes.
    """
    names = _path_names(path)
    name = names[-1]
    dp = dp_axes(mesh, layout)
    tp = tp_axis(mesh, layout)
    sharded_b = batch % dp_size(mesh, layout) == 0
    bax = dp if sharded_b else None
    nd = len(leaf.shape)

    if name == "cache_len":
        return (bax,)

    def seq_axes(S: int):
        axes = []
        if tp and S % _axis_size(mesh, tp) == 0 and S > 1:
            axes.append(tp)
        if not sharded_b and nd >= 3 and S > 1:
            size = dp_size(mesh, layout)
            if (S // (math.prod(_axis_size(mesh, a) for a in axes) or 1)) % size == 0:
                axes = (list(dp) if isinstance(dp, tuple) else [dp]) + axes
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    def mod_ax(dim: int):
        return tp if (tp and dim % _axis_size(mesh, tp) == 0) else None

    if name in ("k", "v"):  # (L, B, S, KV, dh)
        sax = seq_axes(leaf.shape[2])
        if sax is None and tp and leaf.shape[3] % _axis_size(mesh, tp) == 0:
            # sequence not shardable (e.g. enc-dec cross KV, 1500 frames):
            # shard heads instead
            return (None, bax, None, tp, None)
        return (None, bax, sax, None, None)
    if name in ("k_scale", "v_scale"):  # (L, B, S, KV) int8-cache scales
        return (None, bax, seq_axes(leaf.shape[2]), None)
    if name == "ckv":  # (L, B, S, r)
        return (None, bax, seq_axes(leaf.shape[2]), None)
    if name == "kpe":  # (L, B, S, rope_dim)
        return (None, bax, seq_axes(leaf.shape[2]), None)
    if name == "S":  # rwkv state (L, B, H, N, N)
        return (None, bax, mod_ax(leaf.shape[2]), None, None)
    if name == "x_prev":  # (L, B, 1, d)
        return (None, bax, None, mod_ax(leaf.shape[-1]))
    if name == "h":  # rglru (L, B, W)
        return (None, bax, mod_ax(leaf.shape[-1]))
    if name == "conv":  # (L, B, cw-1, W)
        return (None, bax, None, mod_ax(leaf.shape[-1]))
    if name == "ffn":  # rwkv cmix token shift (L, B, 1, d)
        return (None, bax, None, mod_ax(leaf.shape[-1]))
    # enc_kv k/v handled by ("k","v") above; default: batch only
    spec = [None] * nd
    if nd >= 2:
        spec[1] = bax
    return tuple(spec)


def decode_state_specs(cfg: ModelConfig, mesh, batch: int, state, layout: str = "tp") -> dict:
    return {path: decode_state_spec(cfg, mesh, batch, path, leaf, layout)
            for path, leaf in leaves_with_paths(state)}


# ---------------------------------------------------------------------------
# Placement on a DeviceMesh
# ---------------------------------------------------------------------------


def to_placements(mesh, spec: Spec) -> list:
    """One DTensor placement per mesh dim: ``Shard(d)`` on each mesh axis
    that spec entry d names (a tuple of axes shards d over each of them,
    major first, which is mesh order), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def place(mesh, tensor, spec: Spec):
    """``tensor`` as a DTensor laid out by ``spec``: a plain tensor (the whole
    value, the same on every rank) keeps each rank's block, and no data
    moves; a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = to_placements(mesh, spec)
    if isinstance(tensor, DTensor):
        if tuple(tensor.placements) == tuple(placements):
            return tensor
        return tensor.redistribute(mesh, placements)
    return _own_storage(distribute_tensor(tensor, mesh, placements, src_data_rank=None), tensor)


def _own_storage(t, source):
    """A DTensor whose local block shares the whole tensor's storage (a
    slice of it, or all of it where the block is replicated) gets a copy of
    its own: an update in place never reaches the whole tensor, the whole
    tensor can be freed, and a memory tracker counts the block."""
    from torch.distributed.tensor import DTensor

    local = t.to_local()
    if local.untyped_storage()._cdata != source.untyped_storage()._cdata:
        return t
    return DTensor.from_local(local.clone(), t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _place_tree(mesh, tree, spec_of):
    def walk(node, prefix):  # training.tree's order: dict keys sorted, lists in order
        if isinstance(node, dict):
            return {k: walk(node[k], f"{prefix}/{k}" if prefix else str(k)) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(node)]
        return place(mesh, node, spec_of(prefix, node))

    return walk(tree, "")


def param_shardings(cfg: ModelConfig, mesh, params, layout: str = "tp") -> Any:
    """The parameter tree placed on ``mesh`` by ``param_spec``."""
    return _place_tree(mesh, params, lambda path, leaf: param_spec(cfg, mesh, path, leaf, layout))


def decode_state_shardings(cfg: ModelConfig, mesh, batch: int, state, layout: str = "tp"):
    """A decode state placed on ``mesh`` by ``decode_state_spec``."""
    return _place_tree(mesh, state,
                       lambda path, leaf: decode_state_spec(cfg, mesh, batch, path, leaf, layout))


def to_named(mesh, tree_of_specs: dict, tree: dict) -> dict:
    """A flat dict of tensors (a batch) placed by the matching specs."""
    return {k: place(mesh, v, tree_of_specs[k]) for k, v in tree.items()}


def opt_state_shardings(mesh, opt_state, placed_params) -> dict:
    """AdamW moments laid out as their parameters, the step replicated."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.training.tree import leaves, unflatten

    def like(moments):
        return unflatten(moments, [
            _own_storage(distribute_tensor(m, mesh, p.placements, src_data_rank=None), m)
            for m, p in zip(leaves(moments), leaves(placed_params))])

    return {"mu": like(opt_state["mu"]), "nu": like(opt_state["nu"]),
            "step": place(mesh, opt_state["step"], ())}


def local_bytes(tree) -> int:
    """Bytes of this rank's blocks of every leaf (a plain leaf counts whole)."""
    total = 0
    for _, leaf in leaves_with_paths(tree):
        t = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        total += t.numel() * t.element_size()
    return total

"""Per-device cost extraction and roofline terms for a traced step: the
port's counterpart of the JAX package's ``analysis/hlo.py``.

PyTorch has no HLO module to read, so the costs come from the ops
themselves as a step runs (on fake tensors in the dry-run):

* ``CostMode`` is a ``TorchDispatchMode``.  An op on DTensors it hands back
  to DTensor (``NotImplemented``), which splits it into the ops each rank
  runs on its local block, and those reach the mode again.  So every count
  is per device: FLOPs of each local op (``torch.utils.flop_counter``'s
  formulas), the bytes each local op reads and writes (no fusion: an upper
  bound, as XLA:CPU's ``bytes accessed`` is in the JAX package), and every
  ``c10d_functional`` collective with its operand bytes and the mesh dim it
  crosses.  (``FlopCounterMode`` used as it is counts the DTensor-level,
  global product.)
* The whole depth is traced, layer by layer, so no loop body is counted
  once: the depth extrapolation the JAX dry-run needed is not needed.
* The JAX package halved the f32 share of collective bytes
  (``bf16_corrected_bytes``) to undo XLA:CPU's float normalisation of bf16
  buffers.  Fake tensors keep their dtypes, so the bytes are counted as
  they are and nothing is halved.

The roofline constants are the H100 SXM5 80GB HBM3 (700 W) data sheet's
figures, not measurements.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

# c10d_functional op -> the HLO name the JAX package's records use
COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict
    f32_bytes: float = 0.0  # portion of total carried by f32 buffers
    bytes_by_axis: dict = dataclasses.field(default_factory=dict)  # mesh dim -> bytes

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def merged(self, other: "CollectiveStats", scale: float = 1.0) -> "CollectiveStats":
        def add(a: dict, b: dict) -> dict:
            out = dict(a)
            for k, v in b.items():
                out[k] = out.get(k, 0) + v * scale
            return out

        return CollectiveStats(add(self.bytes_by_op, other.bytes_by_op),
                               add(self.count_by_op, other.count_by_op),
                               self.f32_bytes + scale * other.f32_bytes,
                               add(self.bytes_by_axis, other.bytes_by_axis))


@dataclasses.dataclass
class CompiledCosts:
    flops_per_device: float
    bytes_per_device: float
    collectives: CollectiveStats

    def scaled_sub(self, other: "CompiledCosts") -> "CompiledCosts":
        """self - other (a per-layer slope)."""
        return self.plus_scaled(other, -1.0)

    def plus_scaled(self, other: "CompiledCosts", n: float) -> "CompiledCosts":
        return CompiledCosts(
            self.flops_per_device + n * other.flops_per_device,
            self.bytes_per_device + n * other.bytes_per_device,
            self.collectives.merged(other.collectives, n),
        )


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


_SKIP = {"size", "sym_size", "stride", "sym_stride", "numel", "sym_numel", "dim",
         "is_contiguous", "storage_offset", "sym_storage_offset", "wait_tensor",
         "detach", "alias", "view", "_unsafe_view", "t", "transpose",
         "permute", "expand", "unsqueeze", "squeeze", "select", "slice", "as_strided",
         "split", "split_with_sizes", "unbind", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "lift_fresh"}


class CostMode(TorchDispatchMode):
    """Counts per-device FLOPs, op bytes and collectives of what runs inside
    it (see the module note).  ``axis_of_group`` maps a process group's name
    to the mesh dim it spans (``for_mesh``)."""

    def __init__(self, axis_of_group: dict | None = None):
        super().__init__()
        self.axis_of_group = axis_of_group or {}
        self.flops = 0
        self.op_bytes = 0
        self.bytes_by_op: dict = defaultdict(int)
        self.count_by_op: dict = defaultdict(int)
        self.bytes_by_axis: dict = defaultdict(int)
        self.f32_bytes = 0
        # (op, operand shape, dtype, mesh dim, bytes) -> count
        self.collective_events: dict = defaultdict(int)

    @classmethod
    def for_mesh(cls, mesh) -> "CostMode":
        return cls({mesh.get_group(i).group_name: name
                    for i, name in enumerate(mesh.mesh_dim_names)})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor splits it into local ops
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        out = func(*args, **kwargs)
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in COLLECTIVE_OPS:
            op = COLLECTIVE_OPS[name]
            b = _nbytes(args[0])
            group = next((a for a in reversed(args) if isinstance(a, str)), "")
            self.bytes_by_op[op] += b
            self.count_by_op[op] += 1
            axis = self.axis_of_group.get(group, group)
            self.bytes_by_axis[axis] += b
            t = args[0] if isinstance(args[0], torch.Tensor) else next(_tensors(args[0]))
            self.collective_events[(op, tuple(t.shape), str(t.dtype).replace("torch.", ""),
                                    axis, b)] += 1
            if any(t.dtype == torch.float32 for t in _tensors(args[0])):
                self.f32_bytes += b
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name not in _SKIP:
            self.op_bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out

    def costs(self) -> CompiledCosts:
        return CompiledCosts(float(self.flops), float(self.op_bytes),
                             CollectiveStats(dict(self.bytes_by_op), dict(self.count_by_op),
                                             float(self.f32_bytes), dict(self.bytes_by_axis)))


@contextlib.contextmanager
def without_shape_inference():
    """Keep DTensor's own shape inference out of every dispatch mode.

    DTensor infers an op's global output shape the first time it meets the
    op's signature by running it on fake tensors of the *global* shapes,
    under the current modes: a cost or memory counter would count those
    whole-tensor ops once per signature.  Inside this scope that inference
    runs with the modes set aside."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def bare(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = bare
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


# ---------------------------------------------------------------------------
# Roofline: NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit, data-sheet
# figures (dense, no sparsity), not measurements
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989e12  # per card, data sheet
HBM_BW = 3.35e12  # bytes/s per card, data sheet
HBM_BYTES = 80e9  # per card
NVLINK_BW = 450e9  # bytes/s each way per card (900 GB/s both), data sheet: the model axis
IB_BW = 50e9  # bytes/s per card, one 400 Gb/s InfiniBand NIC: the data and pod axes
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}


def roofline_terms(costs: CompiledCosts, chips: int) -> dict:
    """Three terms in seconds (per step).  Counts are per device, so
    ``flops / (chips * peak)`` of the whole step is ``flops_per_device /
    peak``.  The collective term adds each mesh dim's bytes over its link:
    NVLink inside a node (``model``), InfiniBand across nodes."""
    t_compute = costs.flops_per_device / PEAK_FLOPS_BF16
    t_memory = costs.bytes_per_device / HBM_BW
    by_axis = costs.collectives.bytes_by_axis
    t_axis = {a: b / AXIS_BW.get(a, IB_BW) for a, b in by_axis.items()}
    t_collective = sum(t_axis.values())
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "t_collective_by_axis_s": t_axis,
        "dominant": dominant,
        "flops_per_device": costs.flops_per_device,
        "bytes_per_device": costs.bytes_per_device,
        "collective_bytes_per_device": costs.collectives.total_bytes,
        "collective_bytes_by_axis": dict(by_axis),
        "collective_counts": costs.collectives.count_by_op,
        "collective_bytes_by_op": costs.collectives.bytes_by_op,
    }


def model_flops(cfg, shape, chips: int) -> dict:
    """Analytic MODEL_FLOPS: 6·N·D for train, 2·N·D for inference steps
    (N = active params, D = tokens processed by the step)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mf = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mf = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mf = 2.0 * n_active * tokens
    return {"model_flops_global": mf, "model_flops_per_device": mf / chips,
            "active_params": n_active, "total_params": cfg.param_count()}

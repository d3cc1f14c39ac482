"""The port's dry-run (``launch.dryrun``, ``launch.specs``,
``analysis.costs``) against the JAX package's, on the CPU.

- ``specs``: every arch's stand-ins have JAX's leaves, shapes and dtypes,
  on the meta device (nothing allocated).
- ``model_flops`` equals JAX's ``analysis.hlo.model_flops`` for every arch
  and shape.
- ``CostMode`` counts per device: on a fake world of 4 ranks, a DTensor
  matmul counts its local product's FLOPs, and the all-reduce of a partial
  sum its local operand's bytes on the mesh dim it crosses.
- ``run_cell("qwen3-1.7b", "decode_32k", "single")`` (a subprocess: the fake
  group of 256 ranks is process-wide) gives argument bytes equal to the
  sum of local shard sizes reckoned by hand from JAX's specs and shapes,
  JAX's model FLOPs, and traced FLOPs within 0.1% of them (the traced step
  leaves out the embedding lookup's gather and the attention kernel, a
  custom operator without a FLOP formula).
"""
import json
import math
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")

from repro.analysis import hlo as jax_hlo  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import SHAPES_BY_NAME as JAX_SHAPES  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.analysis import costs  # noqa: E402
from repro_torch.configs import SHAPES_BY_NAME, get_config  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402
from repro_torch.training.tree import leaves_with_paths  # noqa: E402

from _support import run  # noqa: E402


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _port_leaves(tree) -> dict:
    out = {}
    for k, v in leaves_with_paths(tree):
        assert v.device.type == "meta", k
        out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name, shape in JAX_SHAPES.items():
        want = _jax_leaves(jspecs.input_specs(jcfg, shape))
        got = _port_leaves(pspecs.input_specs(cfg, SHAPES_BY_NAME[name]))
        assert got == want, name


@pytest.mark.parametrize("shape_name", list(JAX_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_jax(arch, shape_name):
    for chips in (256, 512):
        want = jax_hlo.model_flops(jax_get_config(arch), JAX_SHAPES[shape_name], chips)
        got = costs.model_flops(get_config(arch), SHAPES_BY_NAME[shape_name], chips)
        assert got == want


def test_depth_variants_equal_jax():
    for arch in ARCH_IDS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        shape = SHAPES_BY_NAME["train_4k"]
        assert pspecs.unique_segment_types(cfg) == jspecs.unique_segment_types(jcfg)
        for t in [None] + pspecs.unique_segment_types(cfg):
            v, jv = pspecs.depth_variant(cfg, t, shape), jspecs.depth_variant(jcfg, t, shape)
            assert (v.n_layers, v.n_encoder_layers, v.loss_chunk) == (
                jv.n_layers, jv.n_encoder_layers, jv.loss_chunk)
            if t is not None:
                assert pspecs.layer_multiplier(cfg, t) == jspecs.layer_multiplier(jcfg, t)


def test_roofline_terms_use_the_h100_datasheet_and_split_collectives_by_axis():
    stats = costs.CollectiveStats({"all-gather": 9e9, "all-reduce": 1e9},
                                  {"all-gather": 3, "all-reduce": 1}, 0.0,
                                  {"model": 9e9, "data": 1e9})
    c = costs.CompiledCosts(989e12, 3.35e12, stats)
    r = costs.roofline_terms(c, 256)
    assert r["t_compute_s"] == pytest.approx(1.0) and r["t_memory_s"] == pytest.approx(1.0)
    assert r["t_collective_by_axis_s"] == {"model": pytest.approx(9e9 / 450e9),
                                           "data": pytest.approx(1e9 / 50e9)}
    assert r["t_collective_s"] == pytest.approx(0.02 + 0.02)
    assert r["dominant"] in ("compute", "memory")
    twice = c.plus_scaled(c, 1.0)
    assert twice.collectives.bytes_by_axis == {"model": 18e9, "data": 2e9}
    assert c.plus_scaled(c, 1.0).scaled_sub(c).flops_per_device == c.flops_per_device


_FLOPS = r"""
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Shard, Replicate, distribute_tensor
from repro_torch.analysis.costs import CostMode, without_shape_inference
from repro_torch.launch.dryrun import init_fake_world
from torch.distributed.device_mesh import init_device_mesh

init_fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
with FakeTensorMode():
    a = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Replicate()], src_data_rank=None)
    b = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(1)], src_data_rank=None)
    cm = CostMode.for_mesh(mesh)
    with without_shape_inference(), cm:
        c = a @ b
    out["local"] = [cm.flops, list(c.to_local().shape), cm.count_by_op]
    # contraction sharded over model: a partial sum, all-reduced over model
    a2 = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Shard(1)], src_data_rank=None)
    b2 = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(0)], src_data_rank=None)
    cm2 = CostMode.for_mesh(mesh)
    with without_shape_inference(), cm2:
        c2 = (a2 @ b2).redistribute(mesh, [Shard(0), Replicate()])
    out["partial"] = [cm2.flops, cm2.count_by_op, cm2.bytes_by_axis]
print(json.dumps(out))
"""


def test_cost_mode_counts_per_device():
    [p] = run([sys.executable, "-c", _FLOPS])
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    flops, shape, counts = out["local"]
    assert shape == [32, 8] and flops == 2 * 32 * 32 * 8 and counts == {}
    flops, counts, by_axis = out["partial"]
    assert flops == 2 * 32 * 16 * 16  # (64/2 rows) x (32/2 contraction) x 16
    assert counts == {"all-reduce": 1} and by_axis == {"model": 32 * 16 * 4}


def _hand_argument_bytes(arch: str, shape_name: str) -> int:
    """Sum of local shard bytes of the decode step's arguments, from JAX's
    shapes, dtypes and specs on a (data=32, model=8) stand-in mesh."""

    class Mesh:
        shape = {"data": 32, "model": 8}
        axis_names = ("data", "model")

    mesh, cfg, shape = Mesh(), jax_get_config(arch), JAX_SHAPES[shape_name]
    ispec = jspecs.input_specs(cfg, shape)

    def local(leaf, spec) -> int:
        n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                n //= mesh.shape[a]
        return n

    total = 0
    flat, _ = jax.tree_util.tree_flatten_with_path(ispec["params"])
    total += sum(local(x, jsh.param_spec(cfg, mesh, p, x)) for p, x in flat)
    flat, _ = jax.tree_util.tree_flatten_with_path(ispec["state"])
    total += sum(local(x, jsh.decode_state_spec(cfg, mesh, shape.global_batch, p, x))
                 for p, x in flat)
    tok = ispec["tokens"]
    total += local(tok, (jsh.dp_axes(mesh),))
    return total


def test_run_cell_decode_32k_matches_hand_reckoning(tmp_path):
    out = tmp_path / "rec.json"
    [p] = run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-1.7b",
               "--shape", "decode_32k", "--mesh", "single", "--device-type", "cpu",
               "--out", str(out), "--quiet"])
    assert p.returncode == 0, p.stderr[-3000:]
    rec = json.loads(out.read_text())[0]
    assert "error" not in rec, rec.get("traceback")
    assert rec["chips"] == 256 and rec["mesh_shape"] == {"data": 32, "model": 8}
    assert rec["memory"]["argument_bytes"] == _hand_argument_bytes("qwen3-1.7b", "decode_32k")
    want = jax_hlo.model_flops(jax_get_config("qwen3-1.7b"), JAX_SHAPES["decode_32k"], 256)
    assert rec["model"] == want
    traced = rec["scan_level_costs"]["flops_per_device"]
    assert traced == pytest.approx(want["model_flops_per_device"], rel=1e-3)
    coll = rec["scan_level_costs"]["collective_bytes_by_axis"]
    assert set(coll) == {"data", "model"} and all(v > 0 for v in coll.values())
    rf = rec["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert rf["t_memory_s"] == pytest.approx(rf["analytic_hbm_bytes"]["total"] / 3.35e12)
    assert rf["fits_hbm"] == (rec["memory"]["peak_bytes_est"] <= 80e9)
    assert rec["memory"]["peak_bytes_est"] >= rec["memory"]["argument_bytes"]


def test_decode_attention_traces_on_fake_tensors():
    """The dry-run's fake tensors reach the operator's shape function, and
    neither the plain version nor the kernel (no count moves)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.decode_attention import decode_attention

    n0 = decode_attention.plain_calls, decode_attention.launches
    with FakeTensorMode():
        q, kv = torch.empty(2, 8, 64), torch.empty(2, 300, 4, 64)
        out, lse = decode_attention(q, kv, kv, torch.empty(2, dtype=torch.int32),
                                    return_lse=True)
        assert tuple(out.shape) == (2, 8, 64) and tuple(lse.shape) == (2, 8)
        assert lse.dtype == torch.float32 and type(out).__name__ == "FakeTensor"
        assert decode_attention(q, kv, kv, torch.empty(2, dtype=torch.int32)).shape == q.shape
    assert (decode_attention.plain_calls, decode_attention.launches) == n0


_ZOO = r"""
import json, sys, traceback
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig, shape_applicable
from repro_torch.launch.dryrun import init_fake_world, trace_step

init_fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch).reduced()
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(kind, 32, 4, kind)
        try:
            tr = trace_step(cfg, shape, mesh)
            c = tr["costs"]
            out[f"{arch}:{kind}"] = {"flops": c.flops_per_device,
                                     "coll": c.collectives.total_bytes,
                                     "args": tr["memory"]["argument_bytes"]}
        except Exception:
            out[f"{arch}:{kind}"] = {"error": traceback.format_exc()[-3000:]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def zoo_traces():
    [p] = run([sys.executable, "-c", _ZOO])
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_traces_on_a_mesh(zoo_traces, arch):
    """Each family's train, prefill and decode step at its reduced config on
    a fake (2, 2) mesh: the DTensor path runs through (no DTensor gap), with
    FLOPs and collectives counted."""
    for kind in ("train", "prefill", "decode"):
        rec = zoo_traces[f"{arch}:{kind}"]
        assert "error" not in rec, rec.get("error")
        assert rec["flops"] > 0 and rec["args"] > 0

"""Sharding of the port (``distributed.sharding``, ``act_sharding``, the
model's mesh paths) against the JAX package, on the CPU.

- Spec parity: for every arch, on the meshes (16, 16), (2, 16, 16), (32, 8)
  and (2, 32, 8) and the layouts tp / serve_tp / dp_only, the port's
  ``param_spec`` equals JAX's on every leaf, and so do ``decode_state_spec``
  (each decode shape) and ``batch_spec`` (each train and prefill shape).
  The JAX rules read only a mesh's ``shape`` and ``axis_names``, so a
  stand-in mesh serves both.
- On a real (data=2, model=2) mesh of 4 gloo processes on the CPU (spawned
  once for the module):
  * each rank's local block of every parameter of qwen3's and deepseek's
    reduced configs (tp and dp_only), of a decode state and of a batch
    equals the block of the whole array that JAX's ``NamedSharding`` gives
    the device of the same mesh position (a JAX process with 4 CPU
    devices);
  * one sharded train step of qwen3-1.7b's reduced config (f32) equals
    JAX's unsharded step from the same parameters: the loss and the global
    gradient norm that AdamW clips by to rtol 1e-5;
    the parameters within atol 1e-5 except at most 1e-4 of the entries
    (AdamW's first step divides each gradient entry by its own magnitude,
    so an entry that is rounding noise moves by up to lr either way), and
    those within 2 x lr;
  * sharded greedy decoding (prefill of 4 x 12 tokens into a 32-row cache
    whose sequence is sharded over ``model``, 6 steps) gives JAX's tokens,
    and ``decode_attention`` ran on every rank; so does a 33-row cache,
    whose kv heads the rules put on ``model`` instead;
  * ``apply_moe`` of deepseek's reduced config at capacity factor 1 (so that
    tokens drop) under the mesh, where ``dp_total() == 2``, equals JAX's
    ``apply_moe`` run on each half of the tokens (f32, within 1e-5 of the
    output's largest entry: the packages sum the products in other orders); it
    differs from JAX's run on all the tokens at once, which routes one group
    with another capacity.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import SHAPES_BY_NAME as JAX_SHAPES  # noqa: E402
from repro.configs.base import shape_applicable  # noqa: E402
from repro.distributed import act_sharding as jax_act  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.training.optimizer import OptConfig as JaxOptConfig  # noqa: E402
from repro.training.optimizer import init_opt_state as jax_init_opt  # noqa: E402
from repro.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import act_sharding  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402
from repro_torch.training.tree import leaves_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


class FakeMesh:
    """Minimal stand-in exposing shape/axis_names (no devices needed)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"data": 16, "model": 16}), FakeMesh({"pod": 2, "data": 16, "model": 16}),
          FakeMesh({"data": 32, "model": 8}), FakeMesh({"pod": 2, "data": 32, "model": 8})]
LAYOUTS = ("tp", "serve_tp", "dp_only")


def _jax_path(path) -> str:
    out = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            out.append(str(p.key))
        elif isinstance(p, jax.tree_util.SequenceKey):
            out.append(str(p.idx))
        else:
            out.append(str(p))
    return "/".join(out)


def _jax_specs(tree, fn) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_jax_path(path): tuple(fn(path, leaf)) for path, leaf in flat}


# ---------------------------------------------------------------------------
# spec parity (no processes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jtree, ptree = jspecs.params_spec(jcfg), pspecs.params_spec(cfg)
    for mesh in MESHES:
        for layout in LAYOUTS:
            want = _jax_specs(jtree, lambda p, x: jsh.param_spec(jcfg, mesh, p, x, layout))
            got = sh.param_specs(cfg, mesh, ptree, layout)
            assert got == want, (mesh.shape, layout)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    n = 0
    for name, shape in JAX_SHAPES.items():
        if shape.kind != "decode" or not shape_applicable(jcfg, shape)[0]:
            continue
        jtree = jspecs.decode_state_spec(jcfg, shape)
        ptree = pspecs.decode_state_spec(cfg, shape)
        for mesh in MESHES:
            for layout in LAYOUTS:
                want = _jax_specs(jtree, lambda p, x: jsh.decode_state_spec(
                    jcfg, mesh, shape.global_batch, p, x, layout))
                got = sh.decode_state_specs(cfg, mesh, shape.global_batch, ptree, layout)
                assert got == want, (name, mesh.shape, layout)
                n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name, shape in JAX_SHAPES.items():
        if shape.kind == "decode":
            continue
        for mesh in MESHES:
            for layout in LAYOUTS:
                want = {k: tuple(v) for k, v in jsh.batch_spec(jcfg, mesh, shape, layout).items()}
                assert sh.batch_spec(cfg, mesh, shape, layout) == want, (name, mesh.shape)
                assert sh.tokens_spec(mesh, shape.global_batch, layout) == tuple(
                    jsh.P(jsh.dp_axes(mesh, layout)
                          if shape.global_batch % jsh.dp_size(mesh, layout) == 0 else None))


def test_to_placements_major_first():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh({"pod": 2, "data": 32, "model": 8})
    assert sh.to_placements(mesh, (("pod", "data"), None, "model")) == [Shard(0), Shard(0),
                                                                        Shard(2)]
    assert sh.to_placements(mesh, (None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError):
        sh.to_placements(mesh, (("model", "data"),))


def test_act_resolve_and_dp_total_equal_jax():
    """The logical-axis resolution of ``constrain`` and ``dp_total`` (read
    inside a ``use_mesh`` scope of each package, on a stand-in mesh)."""
    shapes = [(4, 16, 8, 64), (3, 5, 7, 9), (32, 1, 16, 128), (64, 7, 6, 5)]
    specs = [("dp", None, "tp", None), ("tp", "dp", None, None), (None, "data", "model", None)]
    for mesh in MESHES:
        for layout in LAYOUTS:
            with jax_act.use_mesh(mesh, layout):
                want = [[jax_act._resolve(mesh, d, a) for d, a in zip(shp, spec)]
                        for shp in shapes for spec in specs]
                want_dp = jax_act.dp_total()
            act_sharding._STATE.mesh, act_sharding._STATE.layout = mesh, layout
            try:
                got = [list(act_sharding.resolve(mesh, shp, spec)) for shp in shapes
                       for spec in specs]
                got_dp = act_sharding.dp_total()
            finally:
                act_sharding._STATE.mesh, act_sharding._STATE.layout = None, "tp"
            assert got == want and got_dp == want_dp


def test_constrain_outside_a_mesh_returns_its_input():
    x = torch.randn(4, 8)
    assert act_sharding.constrain(x, "dp", "tp") is x
    assert not act_sharding.active() and act_sharding.dp_total() == 1


# ---------------------------------------------------------------------------
# a real (data=2, model=2) mesh of 4 gloo processes
# ---------------------------------------------------------------------------

WORLD = 4
B, S, MAX_LEN, STEPS = 4, 12, 32, 6
TRAIN_B, TRAIN_S = 4, 32
LR = 1e-3

_JAX_BLOCKS = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

cases = pickle.load(open(sys.argv[1], "rb"))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for key, (shape, spec) in cases.items():
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out[key] = [tuple((s.start or 0, s.stop if s.stop is not None else n)
                      for s, n in zip(idx[d], shape)) for d in mesh.devices.flat]
pickle.dump(out, open(sys.argv[2], "wb"))
"""

_RANK = r"""
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.act_sharding import dp_total, use_mesh
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import layers, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import leaves_with_paths

rank, world = int(sys.argv[1]), int(sys.argv[2])
store, data, out = sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
try:
    z = pickle.load(open(data, "rb"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {"coord": mesh.get_coordinate()}

    # local blocks of whole arrays laid out by the rules
    blocks = {}
    for key, (arr, spec) in z["blocks"].items():
        blocks[key] = sh.place(mesh, torch.from_numpy(arr), spec).to_local().numpy()
    res["blocks"] = blocks

    # one sharded train step
    cfg = get_config("qwen3-1.7b").reduced()
    params = sh.param_shardings(cfg, mesh, params_from_numpy(z["qwen_params"], cfg, "cpu"))
    opt = sh.opt_state_shardings(mesh, init_opt_state(params_from_numpy(
        z["qwen_params"], cfg, "cpu")), params)
    from repro_torch.configs.base import ShapeConfig
    bspec = sh.batch_spec(cfg, mesh, ShapeConfig("t", z["train_S"], z["train_B"], "train"))
    batch = sh.to_named(mesh, bspec, {k: torch.from_numpy(v) for k, v in z["batch"].items()})
    step = make_train_step(cfg, OptConfig(**z["opt"]))
    with use_mesh(mesh):
        loss, params, opt, stats = step(params, opt, batch)
    res["loss"] = float(loss.full_tensor())
    res["grad_norm"] = float(stats["grad_norm"].full_tensor())
    res["params"] = {k: v.full_tensor().numpy() for k, v in leaves_with_paths(params)}

    # sharded greedy decoding
    decode_attention.plain_calls = 0
    dparams = sh.param_shardings(cfg, mesh, params_from_numpy(z["qwen_params"], cfg, "cpu"))
    with use_mesh(mesh):
        toks = lm.greedy(dparams, cfg, torch.from_numpy(z["prompt"]), max_len=z["max_len"],
                         steps=z["steps"])
        _, st = lm.prefill(dparams, cfg, torch.from_numpy(z["prompt"]), max_len=z["max_len"])
    res["tokens"] = toks.numpy()
    res["attn_calls"] = decode_attention.plain_calls
    res["cache_placements"] = [(type(p).__name__, getattr(p, "dim", None))
                               for p in st["segments"][0]["mixer"]["k"].placements]
    # a cache of an odd number of rows: its sequence cannot shard over
    # model, so its kv heads do, and each rank attends with its own heads
    with use_mesh(mesh):
        res["tokens_heads"] = lm.greedy(dparams, cfg, torch.from_numpy(z["prompt"]),
                                        max_len=z["max_len"] + 1, steps=z["steps"]).numpy()
        _, st = lm.prefill(dparams, cfg, torch.from_numpy(z["prompt"]), max_len=z["max_len"] + 1)
    res["heads_placements"] = [(type(p).__name__, getattr(p, "dim", None))
                               for p in st["segments"][0]["mixer"]["k"].placements]

    # a DTensor reaches no implementation of the kernel's operator: it raises
    n0 = decode_attention.plain_calls
    dq = sh.place(mesh, torch.randn(4, 4, 16), ("data", None, None))
    dk = sh.place(mesh, torch.randn(4, 8, 2, 16), ("data", "model", None, None))
    try:
        decode_attention(dq, dk, dk, sh.place(mesh, torch.full((4,), 8, dtype=torch.int32),
                                              ("data",)))
        res["dtensor_raises"] = False
    except Exception:
        res["dtensor_raises"] = decode_attention.plain_calls == n0

    # MoE under the mesh: one group per data rank
    mcfg = get_config("deepseek-v2-lite-16b").reduced(capacity_factor=1.0)
    mp = {k: torch.from_numpy(np.array(v)) for k, v in z["moe_params"].items()}
    mp = sh.param_shardings(mcfg, mesh, {"segments": [{"ffn": mp}]})["segments"][0]["ffn"]
    x = sh.place(mesh, torch.from_numpy(z["moe_x"]), ("data", None, None))
    with use_mesh(mesh):
        res["dp_total"] = dp_total()
        res["moe"] = layers.apply_moe(mcfg, lm._traversal(mp), x).full_tensor().numpy()
    pickle.dump(res, open(out, "wb"))
    dist.barrier()  # no rank tears the group down while a peer still uses it
finally:
    dist.destroy_process_group()
"""


def _block_cases(rng):
    """Whole arrays and port specs for the block check: every parameter of
    qwen3's and deepseek's reduced configs (tp and dp_only), a decode state
    and a batch, on the (2, 2) mesh."""
    mesh = FakeMesh({"data": 2, "model": 2})
    cases = {}
    for arch in ("qwen3-1.7b", "deepseek-v2-lite-16b"):
        cfg = get_config(arch).reduced()
        tree = pspecs.params_spec(cfg)
        for layout in ("tp", "dp_only"):
            for path, spec in sh.param_specs(cfg, mesh, tree, layout).items():
                shape = dict(leaves_with_paths(tree))[path].shape
                cases[f"{arch}:{layout}:{path}"] = (
                    rng.standard_normal(tuple(shape)).astype(np.float32), spec)
    cfg = get_config("qwen3-1.7b").reduced()
    st = pspecs.decode_state_spec(cfg, dataclasses.replace(JAX_SHAPES["decode_32k"],
                                                           seq_len=MAX_LEN, global_batch=B))
    for path, spec in sh.decode_state_specs(cfg, mesh, B, st).items():
        shape = dict(leaves_with_paths(st))[path].shape
        cases[f"state:{path}"] = (rng.standard_normal(tuple(shape)).astype(np.float32), spec)
    for k, spec in sh.batch_spec(cfg, mesh, JAX_SHAPES["train_4k"]).items():
        cases[f"batch:{k}"] = (rng.standard_normal((4, 8)).astype(np.float32), spec)
    return cases


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """JAX's results on the CPU, JAX's device blocks (a 4-device JAX
    process), and the port's 4 gloo ranks, each run once."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    toks = rng.integers(0, jcfg.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = dict(lr=LR, warmup_steps=1)
    step = jax_make_train_step(jcfg, JaxOptConfig(**opt))
    jloss, jnew, _, jstats = step(jparams, jax_init_opt(jparams),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    prompt = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jtoks = {}
    for max_len in (MAX_LEN, MAX_LEN + 1):
        logits, state = jax_lm.prefill(jparams, jcfg, jnp.asarray(prompt), max_len=max_len)
        out = []
        for _ in range(STEPS):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            out.append(np.asarray(nxt))
            logits, state = jax_lm.decode_step(jparams, jcfg, nxt, state)
        jtoks[max_len] = np.stack(out, 1)
    mcfg = jax_get_config("deepseek-v2-lite-16b").reduced(capacity_factor=1.0)
    moe_p = jax_layers.init_moe(mcfg, jax.random.PRNGKey(1))
    x = (rng.standard_normal((B, 16, mcfg.d_model)) * 2).astype(np.float32)
    halves = [np.asarray(jax_layers.apply_moe(mcfg, moe_p, jnp.asarray(h)))
              for h in (x[: B // 2], x[B // 2:])]
    whole = np.asarray(jax_layers.apply_moe(mcfg, moe_p, jnp.asarray(x)))

    cases = _block_cases(rng)
    with open(tmp / "specs.pkl", "wb") as f:
        pickle.dump({k: (a.shape, spec) for k, (a, spec) in cases.items()}, f)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", _JAX_BLOCKS, str(tmp / "specs.pkl"),
                    str(tmp / "jax_blocks.pkl")], check=True, env=env, timeout=300)
    with open(tmp / "jax_blocks.pkl", "rb") as f:
        jax_blocks = pickle.load(f)
    data = {"blocks": cases, "qwen_params": np_params, "batch": batch, "opt": opt,
            "train_B": TRAIN_B, "train_S": TRAIN_S, "prompt": prompt, "max_len": MAX_LEN,
            "steps": STEPS, "moe_params": jax.tree.map(np.asarray, moe_p), "moe_x": x}
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    store = tmp / "store"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(WORLD), str(store),
                               str(tmp / "data.pkl"), str(tmp / f"r{r}.pkl")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"r{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "cases": cases, "jax_blocks": jax_blocks,
            "jax_loss": float(jloss), "jax_grad_norm": float(jstats["grad_norm"]),
            "jax_params": {k: np.asarray(v, np.float32) for k, v in
                           leaves_with_paths(jax.tree.map(np.asarray, jnew))},
            "jax_tokens": jtoks[MAX_LEN], "jax_tokens_heads": jtoks[MAX_LEN + 1],
            "moe_halves": np.concatenate(halves),
            "moe_whole": whole}


@pytest.mark.parametrize("kind", ["qwen3-1.7b:tp", "qwen3-1.7b:dp_only",
                                  "deepseek-v2-lite-16b:tp", "deepseek-v2-lite-16b:dp_only",
                                  "state", "batch"])
def test_local_blocks_equal_jax_device_blocks(mesh_run, kind):
    n = 0
    for key, (arr, spec) in mesh_run["cases"].items():
        if not key.startswith(kind + ":"):
            continue
        for res in mesh_run["ranks"]:
            i, j = res["coord"]
            dev = 2 * i + j  # the JAX mesh's device at (data=i, model=j)
            want = arr[tuple(slice(a, b) for a, b in mesh_run["jax_blocks"][key][dev])]
            np.testing.assert_array_equal(res["blocks"][key], want, err_msg=key)
            n += 1
    assert n >= WORLD


def test_sharded_train_step_equals_jax(mesh_run):
    for res in mesh_run["ranks"]:
        np.testing.assert_allclose(res["loss"], mesh_run["jax_loss"], rtol=1e-5)
        # AdamW clips by the norm over every rank's blocks, not a local one
        np.testing.assert_allclose(res["grad_norm"], mesh_run["jax_grad_norm"], rtol=1e-5)
        assert res["grad_norm"] > 1.0  # so the clip (clip_norm 1) acted
    got, want = mesh_run["ranks"][0]["params"], mesh_run["jax_params"]
    assert got.keys() == want.keys()
    total = off = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * LR, k
        off += int((diff > 1e-5).sum())
        total += diff.size
    assert off <= 1e-4 * total
    for res in mesh_run["ranks"][1:]:  # every rank holds the same whole tree
        for k in want:
            np.testing.assert_array_equal(res["params"][k], got[k])


def test_sharded_greedy_decode_equals_jax(mesh_run):
    for res in mesh_run["ranks"]:
        np.testing.assert_array_equal(res["tokens"], mesh_run["jax_tokens"])
        assert res["attn_calls"] == STEPS  # one layer: one kernel call a step
        # (L, B, S, KV, dh): batch over data, the sequence over model
        assert res["cache_placements"] == [("Shard", 1), ("Shard", 2)]
        assert res["dtensor_raises"]
        # ... or, with 33 rows, the kv heads over model
        np.testing.assert_array_equal(res["tokens_heads"], mesh_run["jax_tokens_heads"])
        assert res["heads_placements"] == [("Shard", 1), ("Shard", 3)]


def test_moe_under_a_mesh_routes_per_data_parallel_group(mesh_run):
    for res in mesh_run["ranks"]:
        assert res["dp_total"] == 2
        want = mesh_run["moe_halves"]
        np.testing.assert_allclose(res["moe"], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.abs(mesh_run["moe_whole"] - mesh_run["moe_halves"]).max() > 1e-3

"""The port's training substrate against the JAX package's, on the CPU.

- ``schedule`` at every step 0..total, and ``adamw_update`` on identical
  numpy trees: f32 to rtol 1e-6 (the same f32 arithmetic in the same order;
  only transcendental functions and the order of each leaf's sum of squares
  may differ by an ulp, and atol 1e-9 admits that ulp of the clip scale where
  ``b1 * mu + (1 - b1) * g`` cancels), bf16 parameters within one bf16 ulp.
- A 5-step trajectory of ``make_train_step`` on qwen3's reduced config
  (f32, parameters converted from the JAX ones, lr 3e-3): losses rtol 1e-4;
  after the 5 steps every parameter entry but at most 1e-4 of the tree's
  within atol 1e-5, and those few within 2 x 5 x lr.  AdamW divides each
  gradient entry by its own running RMS, so an entry that is zero up to f32
  rounding (layer 0's ``q_norm[3]`` at step 0 is ~1e-8, against eps 1e-8)
  takes steps whose size is set by rounding noise: that one entry ends
  2.5e-5 to 7.4e-5 apart, depending on the weights.  ``microbatch=2``
  against JAX's ``microbatch=2`` and against the port's own
  ``microbatch=0``.
- ``SyntheticTokenStream.batch_at``: the same bits.
- The int8 gradient compression: codes and scales of ``_quantize_blocks``
  bit for bit, ``ErrorFeedback`` converging, and ``compressed_psum_leaf``
  over 2 gloo processes equal to the JAX 2-pod ``shard_map`` result.
"""
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.data import SyntheticTokenStream as JaxStream  # noqa: E402
from repro.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.training import compression as comp  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.data import SyntheticTokenStream, to_device  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402
from repro_torch.training.tree import leaves_with_paths  # noqa: E402

from _support import SRC, run  # noqa: E402

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=5)


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in leaves_with_paths(jax.tree.map(np.asarray, tree))}


def _tnp(tree):
    return {k: v.float().numpy() for k, v in leaves_with_paths(tree)}


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    # jitted: the eager init compiles each random op on its own (~3 s more)
    jparams = jax.jit(lambda key: jax_lm.init_params(jcfg, key))(jax.random.PRNGKey(0))
    cfg = get_config("qwen3-1.7b").reduced()
    return jcfg, jparams, cfg


def _params(cfg, jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _batch(cfg, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(t, -1, 1)
    labels[:, -1] = -1  # masked
    return {"tokens": t, "labels": labels}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_jax_at_every_step():
    for kw in (dict(warmup_steps=3, total_steps=10), dict(warmup_steps=0, total_steps=7),
               dict(lr=1e-3, warmup_steps=5, total_steps=5, min_lr_frac=0.0)):
        steps = np.arange(kw["total_steps"] + 2, dtype=np.int32)
        want = np.asarray(jopt.schedule(jopt.OptConfig(**kw), jnp.asarray(steps)))
        got = opt.schedule(opt.OptConfig(**kw), torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=str(kw))


def _opt_tree(rng, dtype):
    shapes = {"embed": (12, 8), "final_norm": {"scale": (8,)},
              "segments": [{"w": (2, 8, 16), "b": (2, 16)}, {"w": (3, 16, 8)}]}

    def draw(node, scale):
        if isinstance(node, dict):
            return {k: draw(v, scale) for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v, scale) for v in node]
        return (rng.standard_normal(node) * scale).astype(np.float32)

    params, grads = draw(shapes, 0.5), draw(shapes, 2.0)  # grads clipped: norm > 1
    mu, nu = draw(shapes, 0.1), jax.tree.map(np.abs, draw(shapes, 0.01))
    return params, grads, mu, nu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    params, grads, mu, nu = _opt_tree(np.random.default_rng(3), dtype)
    jdt = jnp.dtype(dtype)
    to_j = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jdt), t)  # noqa: E731
    # copies: the port writes params in place, and for float32 ``.to`` would
    # return the very tensor that views the numpy buffer the JAX arrays may
    # alias while the dispatched jit still reads them
    to_t = lambda t: jax.tree.map(  # noqa: E731
        lambda a: torch.from_numpy(a.copy()).to(getattr(torch, dtype)), t)
    ocfg = dict(lr=2e-3, warmup_steps=4, total_steps=20)
    jst = {"mu": jax.tree.map(jnp.asarray, mu), "nu": jax.tree.map(jnp.asarray, nu),
           "step": jnp.asarray(3, jnp.int32)}
    jp, jo, js = jax.jit(lambda p, g, s: jopt.adamw_update(jopt.OptConfig(**ocfg), p, g, s))(
        to_j(params), to_j(grads), jst)
    # copies: the port updates mu and nu in place, and the JAX arrays may
    # alias the same numpy buffers while the dispatched jit still reads them
    tst = {"mu": jax.tree.map(lambda a: torch.from_numpy(a.copy()), mu),
           "nu": jax.tree.map(lambda a: torch.from_numpy(a.copy()), nu),
           "step": torch.tensor(3, dtype=torch.int32)}
    tp, to, ts = opt.adamw_update(opt.OptConfig(**ocfg), to_t(params), to_t(grads), tst)
    assert int(to["step"]) == int(jo["step"]) == 4
    np.testing.assert_allclose(float(ts["grad_norm"]), float(js["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(ts["lr"]), float(js["lr"]), rtol=1e-6)
    for name in ("mu", "nu"):
        for (k, a), (_, b) in zip(leaves_with_paths(to[name]), leaves_with_paths(
                jax.tree.map(np.asarray, jo[name]))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9, err_msg=f"{name}/{k}")
    for (k, a), (_, b) in zip(leaves_with_paths(tp), leaves_with_paths(jp)):
        assert a.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9, err_msg=k)
        else:  # bf16 bit patterns (monotonic within a sign) at most one step apart
            ta = a.view(torch.int16).numpy().astype(np.int32)
            tb = np.asarray(b).view(np.int16).astype(np.int32)
            assert np.abs(ta - tb).max() <= 1, k


def test_adamw_update_writes_in_place():
    """The update is written into the given tensors (the JAX launcher
    donates its buffers), the step count included."""
    params, grads, mu, nu = _opt_tree(np.random.default_rng(4), "float32")
    mk = lambda t: jax.tree.map(lambda a: torch.from_numpy(a.copy()), t)  # noqa: E731
    p0, g0 = mk(params), mk(grads)
    s0 = {"mu": mk(mu), "nu": mk(nu), "step": torch.tensor(0, dtype=torch.int32)}
    held = [v for _, v in leaves_with_paths(p0)]
    p1, s1, _ = opt.adamw_update(opt.OptConfig(), p0, g0, s0)
    assert [v for _, v in leaves_with_paths(p1)] == held and all(
        a is b for (_, a), (_, b) in zip(leaves_with_paths(p1), leaves_with_paths(p0)))
    assert s1["mu"]["embed"] is s0["mu"]["embed"] and int(s0["step"]) == 1
    assert not torch.equal(p0["embed"], torch.from_numpy(params["embed"]))
    assert all(torch.equal(a, torch.from_numpy(b)) for (_, a), (_, b)
               in zip(leaves_with_paths(g0), leaves_with_paths(grads)))  # grads untouched


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_five_step_trajectory_matches_jax(qwen):
    jcfg, jparams, cfg = qwen
    shape = ShapeConfig("t", 32, 4, "train")
    ds, jds = SyntheticTokenStream(cfg, shape), JaxStream(jcfg, JaxShapeConfig("t", 32, 4, "train"))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt.OptConfig(**OPT)))
    step = make_train_step(cfg, opt.OptConfig(**OPT))
    jp, jo = jparams, jopt.init_opt_state(jparams)
    params = _params(cfg, jparams)
    o = opt_state_from_numpy(jax.tree.map(np.asarray, jo), cfg, device="cpu")
    for s in range(5):
        jl, jp, jo, js = jstep(jp, jo, {k: jnp.asarray(v) for k, v in jds.batch_at(s).items()})
        tl, params, o, ts = step(params, o, to_device(ds.batch_at(s), "cpu"))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, err_msg=f"step {s}")
        np.testing.assert_allclose(float(ts["grad_norm"]), float(js["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(ts["lr"]), float(js["lr"]), rtol=1e-6)
    assert float(tl) < 5.6  # it learns: the first loss is ~ln(256) = 5.55 plus noise
    want, got = _np(jp), _tnp(params)
    assert sorted(got) == sorted(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in sorted(want)])
    assert diff.max() <= 2 * 5 * OPT["lr"]
    assert np.count_nonzero(diff > 1e-5) <= 1e-4 * diff.size, np.sort(diff)[-5:]
    assert int(o["step"]) == int(jo["step"]) == 5


def test_microbatch_matches_jax_and_own_full_batch(qwen):
    jcfg, jparams, cfg = qwen
    b = _batch(cfg, B=4, S=32)
    jo = jopt.init_opt_state(jparams)
    jl, jp, _, _ = jax.jit(jax_make_train_step(jcfg, microbatch=2))(
        jparams, jo, {k: jnp.asarray(v) for k, v in b.items()})
    runs = {}
    for mb in (2, 0):  # each from its own copy: the step updates in place
        params = _params(cfg, jparams)
        runs[mb] = make_train_step(cfg, microbatch=mb)(params, opt.init_opt_state(params),
                                                       to_device(b, "cpu"))
    (l2, p2, _, _), (l0, p0, _, _) = runs[2], runs[0]
    np.testing.assert_allclose(float(l2), float(jl), rtol=1e-5)
    want, got, full = _np(jp), _tnp(p2), _tnp(p0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    # as tests/test_training.py holds the JAX package: the same step either way
    np.testing.assert_allclose(float(l0), float(l2), rtol=1e-4)
    assert max(float(np.abs(full[k] - got[k]).max()) for k in got) < 5e-3


def test_microbatch_accumulates_f32_gradients(qwen):
    """With microbatches the gradients reach the optimizer in f32 (the JAX
    ``zero_g``), also for bf16 parameters; the step keeps bf16 parameters."""
    _, _, cfg = qwen
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.training import train_step as ts

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = lm.init_params(cfg16, seed=0, device="cpu")
    dtypes = {v.dtype for _, v in leaves_with_paths(params)}
    seen = []
    update = ts.adamw_update

    def spy(c, p, g, o, **kw):
        seen.append({v.dtype for _, v in leaves_with_paths(g)})
        return update(c, p, g, o, **kw)

    ts.adamw_update = spy
    try:
        _, p2, _, _ = ts.make_train_step(cfg16, microbatch=2)(
            params, opt.init_opt_state(params), to_device(_batch(cfg16, B=2, S=16), "cpu"))
        ts.make_train_step(cfg16)(params, opt.init_opt_state(params),
                                  to_device(_batch(cfg16, B=2, S=16), "cpu"))
    finally:
        ts.adamw_update = update
    assert seen[0] == {torch.float32}
    assert torch.bfloat16 in seen[1]
    assert {v.dtype for _, v in leaves_with_paths(p2)} == dtypes


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "paligemma-3b", "whisper-medium"])
def test_batch_at_bits_match_jax(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    shape = dict(name="t", seq_len=24, global_batch=3, kind="train")
    jds, ds = JaxStream(jcfg, JaxShapeConfig(**shape)), SyntheticTokenStream(cfg, ShapeConfig(**shape))
    for step, kw in ((0, {}), (7, {}), (3, dict(local_batch=2, batch_offset=1))):
        want, got = jds.batch_at(step, **kw), ds.batch_at(step, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    t = to_device(got, "cpu")
    assert t["tokens"].dtype == torch.int32 and t["tokens"].shape == (2, 24)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_quantize_blocks_codes_and_scales_bit_identical():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1000) * 0.01).astype(np.float32)
    # a block with scale exactly 1.0 and values halfway between codes: both
    # round half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -3.5 -> -4)
    x[:256] = 0.0
    x[:6] = [127.0, 0.5, 1.5, 2.5, -3.5, -0.5]
    for arr, block in ((x, 256), (x[:515], 128), (x.reshape(20, 50), 64)):
        jq, js, jpad = jcomp._quantize_blocks(jnp.asarray(arr), block)
        q, s, pad = comp._quantize_blocks(torch.from_numpy(arr), block)
        assert pad == jpad and q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            comp._dequantize_blocks(q, s, pad, arr.shape).numpy(),
            np.asarray(jcomp._dequantize_blocks(jq, js, jpad, arr.shape)))
        np.testing.assert_array_equal(comp.quantization_residual(torch.from_numpy(arr), block).numpy(),
                                      np.asarray(jcomp.quantization_residual(jnp.asarray(arr), block)))
    assert comp._quantize_blocks(torch.from_numpy(x), 256)[0][0, :6].tolist() == [127, 0, 2, 2, -4, 0]
    assert comp.dcn_bytes_saved(1_000_000_000, 2) == jcomp.dcn_bytes_saved(1_000_000_000, 2)


def test_error_feedback_accumulates_to_truth_as_jax():
    """As tests/test_compression.py holds the JAX package: the sum of sent
    gradients converges to the sum of true ones; here also each step's sent
    gradient and residual equal JAX's."""
    rng = np.random.default_rng(1)
    true = [(rng.standard_normal(512) * 1e-3).astype(np.float32) for _ in range(20)]
    ef, jef = comp.ErrorFeedback.init(torch.from_numpy(true[0])), jcomp.ErrorFeedback.init(
        jnp.asarray(true[0]))
    sent_total = torch.zeros(512)
    for g in true:
        send, ef = comp.ErrorFeedback.apply(torch.from_numpy(g), ef)
        jsend, jef = jcomp.ErrorFeedback.apply(jnp.asarray(g), jef)
        np.testing.assert_array_equal(send.numpy(), np.asarray(jsend))
        np.testing.assert_array_equal(ef.numpy(), np.asarray(jef))
        sent_total += send
    true_total = np.sum(true, axis=0)
    resid = np.abs(sent_total.numpy() - true_total)
    assert resid.max() <= float(np.abs(true_total).max()) / 64.0
    # a tree of leaves, bf16 among them: sent in the leaf's dtype, residual f32
    tree = {"a": torch.from_numpy(true[0]), "b": [torch.from_numpy(true[1]).to(torch.bfloat16)]}
    send, ef = comp.ErrorFeedback.apply(tree, comp.ErrorFeedback.init(tree))
    assert send["b"][0].dtype == torch.bfloat16 and ef["b"][0].dtype == torch.float32


_JAX_2POD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.training.compression import compressed_psum_leaf

mesh = jax.make_mesh((2,), ("pod",))
x = jnp.asarray(np.load(sys.argv[2]))
f = shard_map(lambda v: compressed_psum_leaf(v[0], "pod"),
              mesh=mesh, in_specs=(P("pod", None),), out_specs=P(None), check_rep=False)
with mesh:
    np.save(sys.argv[3], np.asarray(f(x)))
"""

_PORT_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.training.compression import compressed_psum_leaf

rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
try:
    got = compressed_psum_leaf(torch.from_numpy(np.load(data)[rank]))
    np.save(out, got.numpy())
    dist.barrier()
finally:
    dist.destroy_process_group()
"""


def test_compressed_psum_over_2_gloo_ranks_matches_jax_2pod(tmp_path):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 515)) * 0.02).astype(np.float32)  # as test_compression
    np.save(tmp_path / "x.npy", x)
    procs = run([sys.executable, "-c", _JAX_2POD, SRC, str(tmp_path / "x.npy"),
                 str(tmp_path / "jax.npy")],
                *([sys.executable, "-c", _PORT_RANK, str(r), str(tmp_path / "store"),
                   str(tmp_path / "x.npy"), str(tmp_path / f"out{r}.npy")] for r in range(2)),
                timeout=120, env={**os.environ, "XLA_FLAGS": ""})
    for p in procs:
        assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    want = np.load(tmp_path / "jax.npy")
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npy"), want)
    assert np.abs(want - x.sum(0)).max() <= 2 * np.abs(x).max() / 127.0

"""The port's sharded-retrieval slice against the JAX package's.

- ``topk_merge``'s plain version (through the wrapper, on CPU tensors)
  against ``topk_merge_pallas`` in interpret mode, the jnp oracle and
  ``TopK.merge``.  The merge does no arithmetic, so distances are held
  exactly.
- ``make_sharded_search`` over a gloo group of 4 CPU processes, and of 1,
  against JAX's ``reference_search`` / ``make_sharded_search`` on the same
  numpy slab: distances to rtol 1e-4 / atol 1e-5 (f32, two summation
  orders), ids equal except where two distances tie within that tolerance.
- ``scatter_gather_search`` (a numpy copy) bit for bit against JAX's.
- Shard-mode serving over ``SimBackend``, with and without a seeded
  ``FaultPlan``: per-request timelines and state equal the JAX package's.
- The launcher in shard mode with injected faults, on the CPU.
"""
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch
import torch.distributed as dist

from repro import workflows as jax_workflows
from repro.core.backends import SimBackend as JaxSimBackend
from repro.kernels.topk_merge.ref import topk_merge_ref as jax_topk_merge_ref
from repro.kernels.topk_merge.topk_merge import topk_merge_pallas
from repro.retrieval import HybridRetrievalEngine as JaxHybrid
from repro.retrieval import SyntheticEmbedder as JaxEmbedder
from repro.retrieval import distributed as jax_dist
from repro.retrieval.ivf import TopK
from repro.server import Server as JaxServer
from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro_torch import workflows
from repro_torch.core.backends import SimBackend
from repro_torch.kernels.ivf_scan.ref import topk_agreement
from repro_torch.kernels.topk_merge import topk_merge
from repro_torch.launch import serve
from repro_torch.retrieval import HybridRetrievalEngine, IVFIndex, SyntheticEmbedder
from repro_torch.retrieval import distributed as port_dist
from repro_torch.server import Server
from repro_torch.serving.faults import FaultPlan

from _support import run

F32 = dict(rtol=1e-4, atol=1e-5)
NAMES = ["one-shot", "hyde", "recomp", "multistep", "irg"]


# ---------------------------------------------------------------------------
# topk_merge
# ---------------------------------------------------------------------------


def _port_merge(rd, ri, cd, ci):
    n0 = topk_merge.plain_calls
    d, i = topk_merge(*map(torch.from_numpy, (rd, ri, cd, ci)))
    assert topk_merge.plain_calls == n0 + 1  # a CPU tensor takes the plain version
    assert d.dtype == torch.float32 and i.dtype == torch.from_numpy(ri).dtype
    return d.numpy(), i.numpy()


def _pallas(rd, ri, cd, ci):
    return map(np.asarray, topk_merge_pallas(*map(jnp.asarray, (rd, ri, cd, ci)),
                                             qb=8, interpret=True))


def _merge_case(Q, k, m, special=False):
    """The inputs of ``test_kernels.py``'s cases (half-filled scoreboards);
    ``special`` adds NaN / -inf / +inf candidates and run-vs-cand ties."""
    rng = np.random.default_rng(Q + k)
    rd = np.sort(rng.random((Q, k)).astype(np.float32), axis=1)
    rd[:, k // 2:] = np.inf
    ri = rng.integers(0, 1_000_000, (Q, k)).astype(np.int32)
    cd = rng.random((Q, m)).astype(np.float32)
    ci = (rng.integers(0, 1_000_000, (Q, m)) + 2_000_000).astype(np.int32)
    if special:
        rd[:, 0] = cd[:, 0] = -0.5  # a tie for the best slot: the running entry wins
        bad = rng.random((Q, m)) < 0.3
        bad[:, 0] = False
        cd[bad] = rng.choice(np.array([np.nan, -np.inf, np.inf], np.float32), size=int(bad.sum()))
    return rd, ri, cd, ci


@pytest.mark.parametrize("Q,k,m,special", [
    (16, 5, 12, False), (8, 10, 10, False), (24, 20, 4, False), (8, 1, 16, False),
    (16, 5, 12, True), (8, 10, 10, True), (24, 20, 4, True),
])
def test_topk_merge_plain_matches_pallas(Q, k, m, special):
    rd, ri, cd, ci = _merge_case(Q, k, m, special)
    dt, it = _port_merge(rd, ri, cd, ci)
    dp, ip = _pallas(rd, ri, cd, ci)
    np.testing.assert_array_equal(dt, dp)
    fin = np.isfinite(dp)
    np.testing.assert_array_equal(it[fin], ip[fin])
    if special:
        assert not np.isnan(dt).any() and not np.isneginf(dt).any()
        np.testing.assert_array_equal(it[:, 0], ri[:, 0])


@pytest.mark.parametrize("Q,k,m", [(16, 5, 12), (8, 10, 10), (24, 20, 4), (8, 1, 16)])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_topk_merge_plain_matches_jnp_oracle(Q, k, m, id_dtype):
    """On finite and +inf inputs ``lax.top_k`` also breaks ties by position,
    so every slot's id matches, +inf slots included."""
    rd, ri, cd, ci = _merge_case(Q, k, m)
    cd[:, ::3] = rd[:, :1]  # ties across run and cand
    cd[:, 1::4] = np.inf
    ri, ci = ri.astype(id_dtype), ci.astype(id_dtype)
    dt, it = _port_merge(rd, ri, cd, ci)
    dj, ij = map(np.asarray, jax_topk_merge_ref(*map(jnp.asarray, (rd, ri, cd, ci))))
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(it, ij)


def test_topk_merge_plain_matches_topk_class():
    """Merge == ``retrieval.TopK.merge`` on the same data (``test_kernels.py``)."""
    rng = np.random.default_rng(3)
    k, m = 6, 9
    tk = TopK.empty(k).merge(rng.random(5).astype(np.float32), np.arange(5, dtype=np.int64))
    cd = rng.random(m).astype(np.float32)
    ci = np.arange(100, 100 + m, dtype=np.int64)
    want = tk.merge(cd, ci)
    dt, it = _port_merge(tk.dists[None], tk.ids[None], cd[None], ci[None])
    fin = np.isfinite(want.dists)
    np.testing.assert_array_equal(dt[0][fin], want.dists[fin])
    np.testing.assert_array_equal(it[0][fin], want.ids[fin])


def test_topk_merge_inf_slot_ids_differ_from_pallas():
    """The one deliberate difference from the TPU kernel: the ids of +inf
    slots.  The port takes the non-finite entries in position order (a
    stable sort), as ``lax.top_k`` does in ``make_sharded_search``.  The
    Pallas kernel's mask ``where(pos == sel, BIG, work)`` cannot remove an
    entry that is already BIG, so every +inf slot picks position 0's id
    again.  Distances and the ids of finite slots agree."""
    rd = np.array([[0.1, 0.3, np.inf, np.inf, np.inf]], np.float32)
    ri = np.arange(100, 105, dtype=np.int32)[None]
    cd = np.array([[0.2, -np.inf]], np.float32)
    ci = np.array([[500, 501]], np.int32)
    dt, it = _port_merge(rd, ri, cd, ci)
    dp, ip = _pallas(rd, ri, cd, ci)
    np.testing.assert_array_equal(dt, np.float32([[0.1, 0.2, 0.3, np.inf, np.inf]]))
    np.testing.assert_array_equal(dt, dp)
    np.testing.assert_array_equal(it, [[100, 500, 101, 102, 103]])
    np.testing.assert_array_equal(ip, [[100, 500, 101, 100, 100]])


def test_topk_merge_refuses_mixed_inputs():
    d, i = torch.zeros((2, 3)), torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        topk_merge(d, i, d, i.long())
    with pytest.raises(TypeError):
        topk_merge(d.double(), i, d, i)
    with pytest.raises(ValueError):
        topk_merge(d, i, d[:1], i[:1])
    with pytest.raises(ValueError):
        topk_merge(d, i, d[:, :0], i[:, :0])


# ---------------------------------------------------------------------------
# sharded search
# ---------------------------------------------------------------------------

_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.kernels.topk_merge import topk_merge
from repro_torch.retrieval.distributed import make_sharded_search

rank, world, store, data, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
try:
    z = np.load(data)
    Cl = z["slab"].shape[0] // world
    part = slice(rank * Cl, (rank + 1) * Cl)
    f = make_sharded_search(int(z["k"]), group=dist.group.WORLD)
    d, r = f(torch.from_numpy(z["q"]), torch.from_numpy(z["slab"][part]),
             torch.from_numpy(z["valid"][part]))
    np.savez(out, d=d.numpy(), r=r.numpy(), plain_calls=topk_merge.plain_calls)
    dist.barrier()  # no rank tears the group down while a peer still uses it
finally:
    dist.destroy_process_group()
"""


def _sharded_case(rng, Q, C, L, d):
    q = rng.standard_normal((Q, d)).astype(np.float32)
    slab = rng.standard_normal((C, L, d)).astype(np.float32)
    valid = rng.integers(1, L + 1, (C,)).astype(np.int32)
    return q, slab, valid


def _assert_topk_close(dt, rt, dref, rref, nxt):
    dref, nxt, dt = (torch.tensor(np.array(a)) for a in (dref, nxt, dt))
    rref, rt = (torch.tensor(np.array(a, np.int64)) for a in (rref, rt))
    err, ties, bad = topk_agreement(dref, rref, nxt, dt, rt, **F32)
    assert bad == 0, (err, ties, bad)


def test_sharded_search_4_gloo_ranks_matches_jax_reference(tmp_path):
    world, Q, C, L, d, k = 4, 5, 16, 128, 32, 6
    q, slab, valid = _sharded_case(np.random.default_rng(2), Q, C, L, d)
    # tile 4 (rank 1) duplicates tile 0 (rank 0) at the same local position:
    # both ranks compute bit-identical distances, a cross-shard tie that the
    # merge must give to shard 0; q[0] sits on a row of that tile
    slab[4], valid[4] = slab[0], valid[0]
    q[0] = slab[0, 3] + 1e-3
    np.savez(tmp_path / "in.npz", q=q, slab=slab, valid=valid, k=k)
    ranks = run(*([sys.executable, "-c", _RANK, str(r), str(world), str(tmp_path / "store"),
                   str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")]
                  for r in range(world)), timeout=120)
    for r, p in enumerate(ranks):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{(p.stdout + p.stderr)[-3000:]}"
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(world)]
    for o in outs[1:]:  # replicated on every rank
        np.testing.assert_array_equal(o["d"], outs[0]["d"])
        np.testing.assert_array_equal(o["r"], outs[0]["r"])
    assert all(int(o["plain_calls"]) == 1 for o in outs)  # one merge per rank
    dref, rref = map(np.asarray, jax_dist.reference_search(
        jnp.asarray(q), jnp.asarray(slab), jnp.asarray(valid), k + 1))
    _assert_topk_close(outs[0]["d"], outs[0]["r"], dref[:, :k], rref[:, :k], dref[:, k])
    # the duplicated row: shard 0's copy first, then rank 1's
    r0 = list(outs[0]["r"][0])
    assert r0[:2] == [3, 4 * L + 3]


def test_sharded_search_world_of_1_matches_jax_mesh(tmp_path):
    Q, C, L, d, k = 6, 8, 128, 32, 5
    q, slab, valid = _sharded_case(np.random.default_rng(0), Q, C, L, d)
    mesh = jax.make_mesh((1,), ("data",))
    with mesh:
        dj, rj = map(np.asarray, jax_dist.make_sharded_search(mesh, k)(
            jnp.asarray(q), jnp.asarray(slab), jnp.asarray(valid)))
    dnext = np.asarray(jax_dist.reference_search(jnp.asarray(q), jnp.asarray(slab),
                                                 jnp.asarray(valid), k + 1)[0])[:, k]
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        n0 = topk_merge.plain_calls
        dt, rt = port_dist.make_sharded_search(k)(*map(torch.from_numpy, (q, slab, valid)))
        assert topk_merge.plain_calls == n0  # a world of 1 merges nothing
    finally:
        dist.destroy_process_group()
    _assert_topk_close(dt.numpy(), rt.numpy(), dj, rj, dnext)
    dr, rr = port_dist.reference_search(*map(torch.from_numpy, (q, slab, valid)), k)
    np.testing.assert_array_equal(dr.numpy(), dt.numpy())
    np.testing.assert_array_equal(rr.numpy(), rt.numpy())


def _port_index(jidx) -> IVFIndex:
    return IVFIndex(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                    ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_scatter_gather_search_matches_jax(small_index, n_shards):
    tidx = _port_index(small_index)
    sizes = small_index.cluster_sizes()
    jsm = jax_dist.ShardMap.build(sizes, n_shards)
    tsm = port_dist.ShardMap.build(sizes, n_shards)
    np.testing.assert_array_equal(tsm.owner, jsm.owner)
    q = np.random.default_rng(n_shards).standard_normal((4, small_index.dim)).astype(np.float32)
    for shards in (None, set(range(0, n_shards, 2))):
        dj, ij = jax_dist.scatter_gather_search(small_index, q, 16, 5, jsm, shards=shards)
        dt, it = port_dist.scatter_gather_search(tidx, q, 16, 5, tsm, shards=shards)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(it, ij)


# ---------------------------------------------------------------------------
# shard-mode serving
# ---------------------------------------------------------------------------


def _serve(server_cls, backend_cls, wf, index, embedder, hybrid, plan):
    be = backend_cls(index, embedder, hybrid=hybrid, seed=0)
    s = server_cls(index, embedder, mode="hedra", backend=be, nprobe=8,
                   num_ret_workers=4, index_sharding=True, fault_plan=plan)
    for i in range(10):
        s.add_request(f"q{i}", wf.build(NAMES[i % len(NAMES)]), arrival_us=i * 5000.0)
    return s, s.run()


def _assert_close(a, b, path):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for key in a:
            _assert_close(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, err_msg=path, **F32)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, err_msg=path, **F32)
    else:
        assert a == b, path


@pytest.mark.parametrize("fault_seed", [None, 5])
def test_shard_mode_serving_timelines_match_jax(small_index, small_corpus, fault_seed):
    topics = small_corpus[2]
    tidx = _port_index(small_index)
    kw = dict(cache_capacity=8, update_interval=2)
    jhyb = JaxHybrid(small_index, kernel_impl="ref", **kw)
    thyb = HybridRetrievalEngine(tidx, device="cpu", **kw)
    jplan = tplan = None
    if fault_seed is not None:
        args = (fault_seed, 4, 10 * 20_000.0 + 400_000.0)
        jplan = JaxFaultPlan.random(*args, transient_prob=0.1)
        tplan = FaultPlan.random(*args, transient_prob=0.1)
        assert tplan.describe() == jplan.describe()
    js, jm = _serve(JaxServer, JaxSimBackend, jax_workflows, small_index, JaxEmbedder(topics),
                    jhyb, jplan)
    ts, tm = _serve(Server, SimBackend, workflows, tidx, SyntheticEmbedder(topics), thyb, tplan)
    assert thyb.sharded and jhyb.sharded
    assert tm.summary() == jm.summary()
    assert tm.shard_scatters > 0 and tm.shard_merges > 0
    if fault_seed is not None:
        assert tm.worker_deaths >= 1
    assert ts.shard_report() == js.shard_report()
    jdone = {r.request_id: r for r in js.sched.done}
    tdone = {r.request_id: r for r in ts.sched.done}
    assert jdone.keys() == tdone.keys() and len(tdone) == tm.finished
    for rid, jr in jdone.items():
        tr = tdone[rid]
        assert [(t, e) for t, e, _ in tr.events] == [(t, e) for t, e, _ in jr.events]
        _assert_close([p for _, _, p in tr.events], [p for _, _, p in jr.events],
                      f"request {rid} events")
        _assert_close(tr.state, jr.state, f"request {rid} state")
    assert thyb.upload_stats == jhyb.upload_stats


def test_launcher_serves_sharded_with_faults_on_cpu(capsys):
    m = serve.main(["--device", "cpu", "--index-sharding", "--ret-workers", "4",
                    "--fault-seed", "3", "--n-requests", "4", "--max-new", "6",
                    "--workflow", "irg", "--cache-update-interval", "1",
                    "--cache-transit", "0", "--arrival-gap-ms", "1000"])
    assert m.finished + m.shed == 4
    assert m.shard_scatters > 0 and m.worker_deaths == 1
    out = capsys.readouterr().out
    assert "fault plan:" in out and "on cpu" in out

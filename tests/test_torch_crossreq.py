"""The port's cross-request layer (``repro_torch.crossreq``) against the JAX
package's.

Both ``Server``s run over ``SimBackend`` with the example's cross-request
knobs (a 64-entry global cache, dedup threshold 0.95, replication 2 over 2
retrieval workers) and a hybrid engine with ``replication=2``, over one
shared index and duplicate traffic.  ``crossreq_report()``,
``hybrid.stats()`` and every request's event timeline must be equal.
Then the fused plans (``group_fanout > 1``) that run gave go through
``RealBackend.search_charged`` on the CPU with the device path on: the same
ids as the JAX stack, distances within rtol 1e-4 / atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")

from repro import workflows as jax_workflows
from repro.core.backends import RealBackend as JaxRealBackend
from repro.core.backends import SimBackend as JaxSimBackend
from repro.retrieval import DuplicateTrafficEmbedder as JaxDupEmbedder
from repro.retrieval import HybridRetrievalEngine as JaxHybrid
from repro.retrieval import SyntheticEmbedder as JaxEmbedder
from repro.retrieval.ivf import ClusterCostModel as JaxCostModel
from repro.server import Server as JaxServer
from repro.serving.workload import WorkloadProfile as JaxWorkload
from repro.serving.workload import poisson_arrivals
from repro_torch import workflows
from repro_torch.core.backends import RealBackend, SimBackend
from repro_torch.kernels.ivf_scan import ivf_scan
from repro_torch.retrieval import DuplicateTrafficEmbedder, HybridRetrievalEngine, IVFIndex
from repro_torch.retrieval import SyntheticEmbedder
from repro_torch.retrieval.ivf import ClusterCostModel
from repro_torch.retrieval.plan import RetrievalPlan
from repro_torch.server import Server
from repro_torch.serving.workload import WorkloadProfile

F32 = dict(rtol=1e-4, atol=1e-5)
NAMES = ["one-shot", "hyde", "irg", "multistep", "recomp"]
# the cross-request knobs of examples/serve_rag_e2e.py --crossreq
CROSSREQ = dict(global_cache_size=64, dedup_threshold=0.95, replication_factor=2,
                num_ret_workers=2)


def _close(a, b, path):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for key in a:
            _close(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
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


def _hybrid(pkg, index):
    kw = dict(cache_capacity=12, update_interval=4, transit_substages=1, replication=2)
    if pkg == "jax":
        return JaxHybrid(index, kernel_impl="ref", **kw)
    return HybridRetrievalEngine(index, device="cpu", **kw)


def _serve(pkg, index, topics, n=32):
    jax_side = pkg == "jax"
    P = (dict(emb=JaxEmbedder, dup=JaxDupEmbedder, be=JaxSimBackend, server=JaxServer,
              cost=JaxCostModel, wl=JaxWorkload, wf=jax_workflows) if jax_side else
         dict(emb=SyntheticEmbedder, dup=DuplicateTrafficEmbedder, be=SimBackend, server=Server,
              cost=ClusterCostModel, wl=WorkloadProfile, wf=workflows))
    demb = P["dup"](P["emb"](topics), dup_ratio=0.45, pool_size=4)
    hyb = _hybrid(pkg, index)
    fused = []
    orig = hyb.search_plan

    def search_plan(plan, **kw):
        out = orig(plan, **kw)
        if int(plan.group_fanout.max(initial=1)) > 1:
            fused.append(plan)
        return out

    hyb.search_plan = search_plan
    be = P["be"](index, demb, hybrid=hyb,
                 cost_model=P["cost"](fixed_us=150.0, per_vector_us=20.0, per_query_us=2.0),
                 gen_step_base_us=600.0, gen_step_per_seq_us=20.0)
    wl = P["wl"](gen_tokens_mean=14.0, gen_tokens_sigma=0.25, prompt_tokens_mean=48.0)
    s = P["server"](index, demb, mode="hedra", backend=be, workload=wl, nprobe=16, topk=5,
                    **CROSSREQ)
    for i, t in enumerate(poisson_arrivals(70.0, n, seed=5)):
        name = NAMES[demb.canonical_id(i) % len(NAMES)]
        s.add_request(f"q{i}", P["wf"].build(name), arrival_us=float(t))
    m = s.run()
    return s, m, hyb, fused, demb


def port_index(jidx):
    return IVFIndex(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                    ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)


@pytest.fixture(scope="module")
def served(small_index, small_corpus):
    topics = small_corpus[2]
    tidx = port_index(small_index)
    n0 = ivf_scan.plain_calls
    jax_run = _serve("jax", small_index, topics)
    port_run = _serve("port", tidx, topics)
    assert ivf_scan.plain_calls > n0  # the port's device path was taken
    return jax_run, port_run, tidx


def test_crossreq_report_and_hybrid_stats_match_jax(served):
    (js, jm, jhyb, _, _), (ts, tm, thyb, _, _), _ = served
    assert tm.finished == jm.finished == 32
    trep, jrep = ts.crossreq_report(), js.crossreq_report()
    _close(trep, jrep, "crossreq_report")
    dd = trep["dedup"]
    assert dd["exact_subscribed"] + dd["near_subscribed"] > 0  # queries were fused
    assert trep["global_cache"]["inserts"] > 0
    tst, jst = thyb.stats(), jhyb.stats()
    _close(tst, jst, "hybrid.stats()")
    assert thyb.cache.replication == 2 and tst["replica_loads"] > 0
    assert thyb.upload_stats == jhyb.upload_stats
    assert tm.dedup_fanout == jm.dedup_fanout > 0
    _close(tm.summary(), jm.summary(), "summary")


def test_crossreq_timelines_match_jax(served):
    (js, _, _, _, _), (ts, _, _, _, _), _ = served
    jdone = {r.request_id: r for r in js.sched.done}
    tdone = {r.request_id: r for r in ts.sched.done}
    assert jdone.keys() == tdone.keys()
    for rid, jr in jdone.items():
        tr = tdone[rid]
        assert [(t, e) for t, e, _ in tr.events] == [(t, e) for t, e, _ in jr.events]
        _close([p for _, _, p in tr.events], [p for _, _, p in jr.events],
               f"request {rid} events")
        _close(tr.state, jr.state, f"request {rid} state")


def test_fused_plans_through_real_backend_match_jax(served, small_index):
    """Each side's fused plans, run through ``RealBackend.search_charged``
    over a fresh hybrid engine warmed to residency on them; the port takes
    its device path (the plain version of ``ivf_scan`` on the CPU)."""
    (_, _, _, jfused, jdemb), (_, _, _, tfused, tdemb), tidx = served
    assert len(tfused) == len(jfused) > 0
    for tp, jp in zip(tfused, jfused):
        for f in dataclasses.fields(RetrievalPlan):
            if f.name != "group_meta":
                _close(getattr(tp, f.name), getattr(jp, f.name), f"plan.{f.name}")
    sides = []
    for pkg, index, fused, demb, backend_cls in (
            ("jax", small_index, jfused, jdemb, JaxRealBackend),
            ("port", tidx, tfused, tdemb, RealBackend)):
        hyb = _hybrid(pkg, index)
        hyb.cache.update_interval, hyb.cache.transit_substages = 1, 0
        for plan in fused:  # record the accesses; the refresh stages the clusters
            hyb.search_plan(plan)
        be = backend_cls(None, index, demb, hybrid=hyb)
        n0 = ivf_scan.plain_calls
        outs = []
        for plan in fused:
            resident = hyb.resident_mask()
            outs.append((int(resident[plan.seg_cluster].sum()),
                         plan.finalize(be.search_charged(plan, 0)[1]())))
        assert be.fused_saved_us > 0
        if pkg == "port":
            assert ivf_scan.plain_calls > n0
        sides.append(outs)
    (jouts, touts) = sides
    assert sum(n for n, _ in touts) > 0  # some fused segments were resident
    for (tn, tres), (jn, jres) in zip(touts, jouts):
        assert tn == jn
        np.testing.assert_array_equal(tres.ids, jres.ids)
        fin = np.isfinite(jres.dists)
        np.testing.assert_array_equal(np.isfinite(tres.dists), fin)
        np.testing.assert_allclose(tres.dists[fin], jres.dists[fin], **F32)

"""The port's wall-clock ingress (``repro_torch.serving.ingress``) against
the JAX package's.

A wall-clock run of the JAX launcher's stack (reduced qwen3, a 2,000 x 48
corpus in 12 clusters, ``kernel_impl="ref"``) records an ``ArrivalTrace``
and a ``DurationTape``.  Both, saved as JSON, replay into a fresh JAX stack
and into a fresh port stack built from the converted params and the JAX
index's numpy fields: the JAX replay reproduces the recorded fingerprints
bit for bit, and the port's replay matches it event by event (kinds and
times identical, payload floats within rtol 1e-4 / atol 1e-5), taking the
device path exactly as often as the JAX replay (how often depends on the
recording's sub-stage mix, so a hand-built trace covers the device path
for certain).  A closed-loop run of the port replays in the port bit for
bit, and in the JAX package to the same timeline.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")

from repro.configs import get_config as jax_get_config
from repro.core.backends import RealBackend as JaxRealBackend
from repro.models import lm as jax_lm
from repro.retrieval import CorpusConfig, make_corpus
from repro.retrieval import HybridRetrievalEngine as JaxHybrid
from repro.retrieval import IVFIndex as JaxIVFIndex
from repro.retrieval import SyntheticEmbedder as JaxEmbedder
from repro.retrieval.ivf import ClusterCostModel as JaxCostModel
from repro.retrieval.plan import PlanBuilder as JaxPlanBuilder
from repro.server import Server as JaxServer
from repro.serving import ingress as jax_ingress
from repro.serving.engine import GenerationEngine as JaxEngine
from repro.serving.workload import MIXES as JAX_MIXES
from repro_torch.configs import get_config
from repro_torch.kernels.ivf_scan import ivf_scan
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.retrieval import HybridRetrievalEngine, IVFIndex, SyntheticEmbedder
from repro_torch.retrieval.ivf import ClusterCostModel
from repro_torch.retrieval.plan import PlanBuilder
from repro_torch.serving import ingress
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.workload import ClosedLoopSpec

F32 = dict(rtol=1e-4, atol=1e-5)
MAX_NEW, MAX_LEN, SPEEDUP = 8, 96, 200.0
# a refresh every sub-stage with no transit; each stack's cache is warmed
# the same way before it serves, so that the device path runs however the
# wall clock batches the few requests into sub-stages
HOT = dict(cache_capacity=8, update_interval=1, transit_substages=0)
# every stack schedules by the same cost model: RealBackend's own is
# calibrated by timing host scans anew for each stack, and the tape does
# not record it
COST = dict(fixed_us=20.0, per_vector_us=0.05, per_query_us=2.0)


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


def assert_timelines_match(ts, js):
    """The ``test_torch_serving.py`` rule: per request, event kinds and
    times identical, payloads and state equal up to f32 tolerance."""
    jdone = {r.request_id: r for r in js.sched.done}
    tdone = {r.request_id: r for r in ts.sched.done}
    assert jdone.keys() == tdone.keys() and len(tdone) > 0
    for rid, jr in jdone.items():
        tr = tdone[rid]
        assert [(t, e) for t, e, _ in tr.events] == [(t, e) for t, e, _ in jr.events]
        _close([p for _, _, p in tr.events], [p for _, _, p in jr.events], f"request {rid} events")
        _close(tr.state, jr.state, f"request {rid} state")


def _prompts(vocab, n=16):
    return [(np.frombuffer(f"query {i}".encode(), np.uint8).astype(np.int32) % (vocab - 2)) + 1
            for i in range(n)]


@pytest.fixture(scope="module")
def world():
    docs, _, topics = make_corpus(CorpusConfig(n_docs=2000, dim=48, n_topics=64))
    jidx = JaxIVFIndex.build(docs, n_clusters=12, iters=4)
    tidx = IVFIndex(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                    ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen3-1.7b").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return dict(topics=topics, jidx=jidx, tidx=tidx, jcfg=jcfg, jparams=jparams, cfg=cfg,
                params=params)


def _warm(hybrid, builder_cls):
    """One plan probing every cluster from its own centroid, run twice: the
    refreshes at their ends stage 8 of the 12 clusters."""
    idx = hybrid.index
    b = builder_cls()
    for c in range(idx.n_clusters):
        b.add(idx.centroids[c].astype(np.float32), [c], k=5)
    plan = b.build()
    for _ in range(2):
        hybrid.search_plan(plan)
    assert hybrid.resident_mask().sum() == HOT["cache_capacity"]
    return hybrid


def _count_device_scans(hybrid):
    """From here on, count ``hybrid``'s device-path scans and the items they
    carry (its ``_device_scan``, which both packages' engines share)."""
    counts = {"scans": 0, "items": 0}
    scan = hybrid._device_scan

    def counted(*args, **kwargs):
        n = scan(*args, **kwargs)
        counts["scans"] += 1
        counts["items"] += n
        return n

    hybrid._device_scan = counted
    return counts


def jax_stack(w):
    """A fresh stack as the JAX launcher builds one for ``--wallclock``."""
    idx, cfg = w["jidx"], w["jcfg"]
    emb = JaxEmbedder(w["topics"])
    hybrid = _warm(JaxHybrid(idx, kernel_impl="ref", **HOT), JaxPlanBuilder)
    engine = JaxEngine(cfg, w["jparams"], max_batch=8, max_len=MAX_LEN, eos_id=0)
    backend = JaxRealBackend(engine, idx, emb, hybrid=hybrid)
    backend.cluster_cost_model = JaxCostModel(**COST)
    pending = _prompts(cfg.vocab_size)
    orig = backend.gen_duration

    def gen_duration(n_prefill_tokens, batch, n_steps):
        while engine.can_admit() and pending:
            engine.add_sequence(pending.pop(0), max_new=MAX_NEW)
        return orig(n_prefill_tokens, batch, n_steps)

    backend.gen_duration = gen_duration
    return JaxServer(idx, emb, mode="hedra", backend=backend, nprobe=8,
                     external_heartbeats=True, fault_tolerance=True)


def port_stack(w):
    """A fresh stack through the port launcher's ``build_server``."""
    idx, cfg = w["tidx"], w["cfg"]
    hybrid = _warm(HybridRetrievalEngine(idx, device="cpu", **HOT), PlanBuilder)
    engine = GenerationEngine(cfg, w["params"], max_batch=8, max_len=MAX_LEN, eos_id=0,
                              device="cpu")
    return serve.build_server(engine, idx, SyntheticEmbedder(w["topics"]), hybrid,
                              _prompts(cfg.vocab_size), max_new=MAX_NEW,
                              cost_model=ClusterCostModel(**COST),
                              external_heartbeats=True, fault_tolerance=True)


@pytest.fixture(scope="module")
def jax_recording(world):
    s = jax_stack(world)
    tape = jax_ingress.DurationTape()
    jax_ingress.tape_backend(s.backend, tape, mode="record")
    stream = JAX_MIXES["balanced"].sample(6, rate_per_s=50.0, seed=3)
    m, trace = s.serve_wallclock(stream, speedup=SPEEDUP, max_wall_s=60.0)
    assert m.finished == 6
    assert {r.kind for r in trace.rows} >= {"arrival", "heartbeat"}
    return s, trace.to_json(), json.dumps(tape.to_dict())


def test_jax_wallclock_run_replays_in_both_packages(world, jax_recording):
    rec, trace_json, tape_json = jax_recording
    # the JAX replay: the recorded fingerprints, bit for bit
    js = jax_stack(world)
    js.device_scans = _count_device_scans(js.backend.hybrid)
    jtape = jax_ingress.DurationTape.from_dict(json.loads(tape_json))
    jax_ingress.tape_backend(js.backend, jtape, mode="replay")
    jax_ingress.replay_trace(js, jax_ingress.ArrivalTrace.from_dict(json.loads(trace_json)))
    assert js.fingerprints() == rec.fingerprints()
    # the port's replay of the same JSON files: the same timeline
    ts = port_stack(world)
    tcount = _count_device_scans(ts.backend.hybrid)
    n0 = ivf_scan.plain_calls
    ttape = ingress.DurationTape.from_dict(json.loads(tape_json))
    ingress.tape_backend(ts.backend, ttape, mode="replay")
    tm = ingress.replay_trace(ts, ingress.ArrivalTrace.from_dict(json.loads(trace_json)))
    assert tm.finished == 6 and ttape.remaining() == 0 == jtape.remaining()
    # the port's replay took the device path exactly as often as the JAX
    # replay (how often depends on the recording's sub-stage mix), each
    # time through the port's ivf_scan
    assert tcount == js.device_scans
    assert ivf_scan.plain_calls - n0 == tcount["scans"]
    tstats, jstats = ts.backend.hybrid.stats(), js.backend.hybrid.stats()
    for key in ("hits", "misses", "stale_fallbacks"):
        assert tstats[key] == jstats[key], key
    assert_timelines_match(ts, js)
    _close(tm.summary(), js.sched.metrics.summary(), "summary")


def test_port_replay_of_a_hand_built_trace_takes_the_device_path(world):
    """Three arrivals written by hand, each with a heartbeat: every
    retrieval sub-stage probes 8 of the 12 clusters, 8 of which the warmed
    cache holds, so the replay takes the device path whatever the wall
    clock would have done."""
    rows = []
    for i, wf in enumerate(("one-shot", "hyde", "irg")):
        rows.append(ingress.TraceRow(seq=-1, t_us=i * 2000.0, kind=ingress.HEARTBEAT, wid=0))
        rows.append(ingress.TraceRow(seq=i, t_us=i * 2000.0, kind=ingress.ARRIVAL, workflow=wf,
                                     text=f"query {i}", request_id=i))
    trace = ingress.ArrivalTrace(rows)
    ts = port_stack(world)
    count = _count_device_scans(ts.backend.hybrid)
    n0 = ivf_scan.plain_calls
    tm = ingress.replay_trace(ts, ingress.ArrivalTrace.from_dict(json.loads(trace.to_json())))
    assert tm.finished == 3
    assert count["scans"] > 0 and count["items"] > 0
    assert ivf_scan.plain_calls - n0 == count["scans"]
    assert ts.backend.hybrid.stats()["hits"] > 0


def test_trace_and_tape_json_cross_load(jax_recording):
    _, trace_json, tape_json = jax_recording
    t = ingress.ArrivalTrace.from_dict(json.loads(trace_json))
    assert t.to_json() == trace_json
    assert json.dumps(ingress.DurationTape.from_dict(json.loads(tape_json)).to_dict()) == tape_json
    back = jax_ingress.ArrivalTrace.from_dict(json.loads(t.to_json()))
    assert back.to_json() == trace_json


def test_port_closed_loop_replays_bit_identically(world):
    spec = ClosedLoopSpec(name="mixed", weights={"one-shot": 1.0, "hyde": 1.0},
                          num_clients=2, requests_per_client=2, think_time_s=0.01)
    s = port_stack(world)
    tape = ingress.DurationTape()
    ingress.tape_backend(s.backend, tape, mode="record")
    m, trace = s.serve_wallclock(closed_loop=spec, speedup=SPEEDUP, max_wall_s=60.0)
    assert m.finished == 4
    trace_json, tape_json = trace.to_json(), json.dumps(tape.to_dict())
    replica = port_stack(world)
    ingress.tape_backend(replica.backend, ingress.DurationTape.from_dict(json.loads(tape_json)),
                         mode="replay")
    ingress.replay_trace(replica, ingress.ArrivalTrace.from_dict(json.loads(trace_json)))
    assert replica.fingerprints() == s.fingerprints()
    # the port's files load in the JAX package and replay to the same timeline
    js = jax_stack(world)
    jax_ingress.tape_backend(js.backend, jax_ingress.DurationTape.from_dict(json.loads(tape_json)),
                             mode="replay")
    jax_ingress.replay_trace(js, jax_ingress.ArrivalTrace.from_dict(json.loads(trace_json)))
    assert_timelines_match(s, js)

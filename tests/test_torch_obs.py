"""The port's observability layer (``repro_torch.obs``) against the JAX
package's.

Both ``Server``s run over ``SimBackend`` with tracing and telemetry on,
each with its own package's hybrid engine (device path on) over one shared
index: the port's ``IVFIndex`` is built from the JAX index's numpy fields.
The Perfetto trace is compared event by event, the Prometheus exposition
line by line and the attribution report row by row: names, kinds and times
must be identical, other floats agree within rtol 1e-4 / atol 1e-5 (f32
distances from two summation orders).
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")

from repro.core.backends import SimBackend as JaxSimBackend
from repro.obs.trace import validate_trace
from repro.retrieval import HybridRetrievalEngine as JaxHybrid
from repro.retrieval import SyntheticEmbedder as JaxEmbedder
from repro.server import Server as JaxServer
from repro.serving.workload import MIXES as JAX_MIXES
from repro_torch.core.backends import SimBackend
from repro_torch.kernels.ivf_scan import ivf_scan
from repro_torch.obs.trace import validate_trace as port_validate_trace
from repro_torch.retrieval import HybridRetrievalEngine, IVFIndex, SyntheticEmbedder
from repro_torch.server import Server
from repro_torch.serving.workload import MIXES

F32 = dict(rtol=1e-4, atol=1e-5)
# trace-event fields that are names, kinds, ids or times: compared exactly
EXACT = {"name", "ph", "cat", "pid", "tid", "id", "ts", "dur", "s", "bp"}


def _close(a, b, path, exact=False):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for key in a:
            _close(a[key], b[key], f"{path}[{key!r}]", exact or key in EXACT)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", exact)
    elif isinstance(a, float) and not exact:
        np.testing.assert_allclose(a, b, err_msg=path, **F32)
    else:
        assert a == b, path


def port_index(jidx):
    return IVFIndex(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                    ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)


def _serve(pkg, index, topics, mix_name, n, **kw):
    """One package's stack: ``pkg`` is "jax" or "port"."""
    jax_side = pkg == "jax"
    hyb_kw = dict(cache_capacity=8, update_interval=2)
    if jax_side:
        hyb = JaxHybrid(index, kernel_impl="ref", **hyb_kw)
        emb, backend_cls, server_cls, mixes = JaxEmbedder(topics), JaxSimBackend, JaxServer, JAX_MIXES
    else:
        hyb = HybridRetrievalEngine(index, device="cpu", **hyb_kw)
        emb, backend_cls, server_cls, mixes = SyntheticEmbedder(topics), SimBackend, Server, MIXES
    mix = mixes[mix_name]
    be = backend_cls(index, emb, hybrid=hyb, seed=0)
    s = server_cls(index, emb, mode="hedra", backend=be, nprobe=8, workload=mix.profile(), **kw)
    m = s.serve(mix.sample(n, rate_per_s=120.0, seed=5))
    return s, m, hyb


@pytest.fixture(scope="module")
def served(small_index, small_corpus):
    topics = small_corpus[2]
    n0 = ivf_scan.plain_calls
    kw = dict(tracing=True, telemetry=True, num_ret_workers=2)
    js, jm, _ = _serve("jax", small_index, topics, "heterogeneous", 14, **kw)
    ts, tm, _ = _serve("port", port_index(small_index), topics, "heterogeneous", 14, **kw)
    assert ivf_scan.plain_calls > n0  # the port's device path was taken
    assert tm.finished == jm.finished == 14
    return js, ts


def test_trace_events_match_jax(served):
    js, ts = served
    jt, tt = js.export_trace(), ts.export_trace()
    port_validate_trace(tt)
    validate_trace(json.loads(json.dumps(tt)))  # the port's trace is valid to the JAX checker
    assert len(tt["traceEvents"]) == len(jt["traceEvents"]) > 0
    for i, (te, je) in enumerate(zip(tt["traceEvents"], jt["traceEvents"])):
        _close(te, je, f"traceEvents[{i}]")
    # the generator names its own module: repro.obs.trace in the JAX package
    jother = dict(jt["otherData"], generator=jt["otherData"]["generator"].replace(
        "repro.", "repro_torch.", 1))
    _close(dict(tt, traceEvents=[]), dict(jt, traceEvents=[], otherData=jother), "trace")


def test_prometheus_exposition_matches_jax(served):
    js, ts = served
    jsnap, tsnap = js.metrics_snapshot(), ts.metrics_snapshot()
    jl, tl = jsnap["prometheus"].splitlines(), tsnap["prometheus"].splitlines()
    assert len(tl) == len(jl) > 0
    for t_line, j_line in zip(tl, jl):
        if t_line.startswith("#"):
            assert t_line == j_line
            continue
        t_name, t_val = t_line.rsplit(" ", 1)
        j_name, j_val = j_line.rsplit(" ", 1)
        assert t_name == j_name
        np.testing.assert_allclose(float(t_val), float(j_val), err_msg=t_name, **F32)
    _close(tsnap["timeline"], jsnap["timeline"], "timeline")


def test_attribution_rows_match_jax(served):
    js, ts = served
    trep = ts.attribution_report(check=True)
    jrep = js.attribution_report(check=True)
    _close(trep, jrep, "attribution")
    assert trep["finished"] == 14 and len(trep["per_request"]) == 14
    assert trep["max_rel_residual"] <= 1e-6


def test_obs_is_passive_in_the_port(small_index, small_corpus):
    """Tracing and telemetry on leave the port's event timelines as they
    are with both off (the JAX package's passivity contract)."""
    topics, idx = small_corpus[2], port_index(small_index)
    on, _, _ = _serve("port", idx, topics, "balanced", 10, tracing=True, telemetry=True)
    off, _, _ = _serve("port", idx, topics, "balanced", 10)
    assert on.fingerprints() == off.fingerprints()

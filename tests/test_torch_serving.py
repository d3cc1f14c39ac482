"""The port's serving stack against the JAX package's.

Both ``Server``s run over ``SimBackend`` (the modelled clock), each with its
own package's ``HybridRetrievalEngine`` and the device path turned on, over
one shared index: the port's ``IVFIndex`` is built from the JAX index's
numpy fields.  Every request's event kinds and times must be identical and
its workflow state equal, with floats held to rtol 1e-4 / atol 1e-5 (f32
distances from two summation orders).  The port's launcher then serves a
reduced model end to end on the CPU.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import torch  # noqa: F401

from repro import workflows as jax_workflows
from repro.core.backends import SimBackend as JaxSimBackend
from repro.retrieval import HybridRetrievalEngine as JaxHybrid
from repro.retrieval import SyntheticEmbedder as JaxEmbedder
from repro.server import Server as JaxServer
from repro_torch import workflows
from repro_torch.core.backends import SimBackend
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.ivf_scan import ivf_scan
from repro_torch.launch import serve
from repro_torch.retrieval import HybridRetrievalEngine, IVFIndex, SyntheticEmbedder
from repro_torch.server import Server

NAMES = ["one-shot", "hyde", "recomp", "multistep", "irg"]
F32 = dict(rtol=1e-4, atol=1e-5)


def _serve(server_cls, backend_cls, wf, index, embedder, hybrid, n=10):
    be = backend_cls(index, embedder, hybrid=hybrid, seed=0)
    s = server_cls(index, embedder, mode="hedra", backend=be, nprobe=8)
    for i in range(n):
        s.add_request(f"q{i}", wf.build(NAMES[i % len(NAMES)]), arrival_us=i * 5000.0)
    m = s.run()
    return s, m


def _assert_close(a, b, path="state"):
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


def test_serving_timelines_match_jax(small_index, small_corpus):
    topics = small_corpus[2]
    jidx = small_index
    tidx = IVFIndex(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                    ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)
    kw = dict(cache_capacity=8, update_interval=2)
    jhyb = JaxHybrid(jidx, kernel_impl="ref", **kw)
    thyb = HybridRetrievalEngine(tidx, device="cpu", **kw)
    n0 = ivf_scan.plain_calls
    js, jm = _serve(JaxServer, JaxSimBackend, jax_workflows, jidx, JaxEmbedder(topics), jhyb)
    ts, tm = _serve(Server, SimBackend, workflows, tidx, SyntheticEmbedder(topics), thyb)
    assert tm.finished == jm.finished == 10
    assert ivf_scan.plain_calls > n0  # the port's device path was taken
    jdone = {r.request_id: r for r in js.sched.done}
    tdone = {r.request_id: r for r in ts.sched.done}
    assert jdone.keys() == tdone.keys()
    for rid, jr in jdone.items():
        tr = tdone[rid]
        assert [(t, e) for t, e, _ in tr.events] == [(t, e) for t, e, _ in jr.events]
        _assert_close([p for _, _, p in tr.events], [p for _, _, p in jr.events],
                      f"request {rid} events")
        _assert_close(tr.state, jr.state, f"request {rid} state")
    assert thyb.upload_stats == jhyb.upload_stats


@pytest.mark.parametrize("workflow", ["multistep", "irg"])
def test_launcher_serves_on_cpu(workflow, capsys):
    a0, s0 = decode_attention.plain_calls, ivf_scan.plain_calls
    m = serve.main(["--device", "cpu", "--n-requests", "4", "--max-new", "6",
                    "--workflow", workflow, "--cache-update-interval", "1",
                    "--cache-transit", "0", "--arrival-gap-ms", "1000"])
    assert m.finished == 4
    assert decode_attention.plain_calls > a0
    assert ivf_scan.plain_calls > s0
    assert "on cpu" in capsys.readouterr().out

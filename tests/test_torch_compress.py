"""The compress stage in the port: ``training/compression.py``'s
``block_saliency`` against the JAX package's (both numpy, so equal bit for
bit), and the ten-class ``heterogeneous`` mix, whose ``compress`` and
``pipeline`` workflows reach it, served by both packages' ``SimBackend``
stacks to the same timelines (the ``test_torch_serving.py`` rule)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")

from repro.core.backends import SimBackend as JaxSimBackend
from repro.retrieval import HybridRetrievalEngine as JaxHybrid
from repro.retrieval import SyntheticEmbedder as JaxEmbedder
from repro.server import Server as JaxServer
from repro.serving.workload import MIXES as JAX_MIXES
from repro.training.compression import block_saliency as jax_block_saliency
from repro_torch.core.backends import SimBackend
from repro_torch.retrieval import HybridRetrievalEngine, IVFIndex, SyntheticEmbedder
from repro_torch.server import Server
from repro_torch.serving.workload import MIXES
from repro_torch.training.compression import block_saliency

F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,block", [((48,), 256), ((7, 48), 16), ((5, 300), 256),
                                         ((3, 1024), 256), ((64, 100), 32), ((1, 1), 8)])
def test_block_saliency_equals_jax(shape, block):
    rng = np.random.default_rng(sum(shape) + block)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0)).astype(np.float32)
    got, want = block_saliency(x, block), jax_block_saliency(x, block)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


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


def test_heterogeneous_mix_timelines_match_jax(small_index, small_corpus):
    topics, jidx = small_corpus[2], small_index
    tidx = IVFIndex(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                    ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)
    runs = []
    for idx, emb, hyb, be_cls, server_cls, mix in (
            (jidx, JaxEmbedder(topics), JaxHybrid(jidx, cache_capacity=8, kernel_impl="ref"),
             JaxSimBackend, JaxServer, JAX_MIXES["heterogeneous"]),
            (tidx, SyntheticEmbedder(topics), HybridRetrievalEngine(tidx, cache_capacity=8,
                                                                    device="cpu"),
             SimBackend, Server, MIXES["heterogeneous"])):
        stream = mix.sample(14, rate_per_s=120.0, seed=3)
        be = be_cls(idx, emb, hybrid=hyb, seed=0)
        s = server_cls(idx, emb, mode="hedra", backend=be, nprobe=8, workload=mix.profile())
        runs.append((s, s.serve(stream), stream))
    (js, jm, stream), (ts, tm, _) = runs
    assert {"compress"} <= {it.workflow for it in stream}
    assert tm.finished == jm.finished == 14
    assert tm.stage_tasks == jm.stage_tasks > 0  # host stages (rerank, compress) ran
    jdone = {r.request_id: r for r in js.sched.done}
    tdone = {r.request_id: r for r in ts.sched.done}
    assert jdone.keys() == tdone.keys()
    for rid, jr in jdone.items():
        tr = tdone[rid]
        assert [(t, e) for t, e, _ in tr.events] == [(t, e) for t, e, _ in jr.events]
        _close([p for _, _, p in tr.events], [p for _, _, p in jr.events], f"request {rid} events")
        _close(tr.state, jr.state, f"request {rid} state")

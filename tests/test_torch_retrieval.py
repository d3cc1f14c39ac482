"""The port's k-means, IVF index and hybrid retrieval engine against the JAX
package's, on a small synthetic corpus (12,000 docs, d=48).

Inputs come from the seeded ``make_corpus`` (numpy) and go to both sides.
Centroids are f32 sums of a few hundred rows divided by their count: held
to rtol 1e-4 / atol 1e-5, as the f32 kernels are.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import torch

from repro.retrieval import HybridRetrievalEngine as JaxHybrid
from repro.retrieval.kmeans import kmeans as jax_kmeans
from repro.retrieval.plan import PlanBuilder as JaxPlanBuilder
from repro_torch.kernels.ivf_scan import ivf_scan
from repro_torch.retrieval import HybridRetrievalEngine, IVFIndex
from repro_torch.retrieval.kmeans import assign_clusters, kmeans
from repro_torch.retrieval.plan import PlanBuilder

F32 = dict(rtol=1e-4, atol=1e-5)


def _port_index(jidx) -> IVFIndex:
    """The port's index over the JAX index's numpy fields."""
    return IVFIndex(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                    ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)


@pytest.mark.parametrize("k,iters", [(24, 3), (48, 5)])
def test_kmeans_matches_jax_from_same_init(small_corpus, k, iters):
    docs = small_corpus[0][:4000]
    key = jax.random.PRNGKey(7)
    # the JAX version's own init draw, handed to the port explicitly
    init_idx = np.asarray(jax.random.choice(key, docs.shape[0], shape=(k,), replace=False))
    jc, ja = map(np.asarray, jax_kmeans(key, docs, k, iters=iters))
    tc, ta = kmeans(torch.from_numpy(docs), k, iters=iters, init_idx=init_idx)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_allclose(tc.numpy(), jc, **F32)


def test_kmeans_reseeds_empty_clusters_from_data():
    """Two identical init centroids: the second is empty after assignment
    (argmin takes the first) and is reseeded with data[(idx + i) % N]."""
    data = torch.tensor([[0.0, 0.0], [0.0, 0.1], [5.0, 5.0], [5.0, 5.1]])
    cent, asn = kmeans(data, 3, iters=1, init_idx=np.array([0, 0, 2]))
    np.testing.assert_allclose(cent[1].numpy(), data[(0 + 0) % 4].numpy())
    np.testing.assert_allclose(cent[0].numpy(), [0.0, 0.05], atol=1e-6)
    a, _ = assign_clusters(data, cent)
    assert torch.equal(a, asn)


def test_ivf_build_on_cpu(small_corpus):
    docs = small_corpus[0][:3000]
    idx = IVFIndex.build(docs, 16, iters=3, device="cpu")
    assert idx.n_clusters == 16 and idx.flat.shape == docs.shape
    assert sorted(idx.ids.tolist()) == list(range(3000))
    # same draw as the default: np.random.default_rng(seed)
    idx2 = IVFIndex.build(docs, 16, iters=3, device="cpu",
                          init_idx=np.random.default_rng(0).choice(3000, 16, replace=False))
    np.testing.assert_array_equal(idx.offsets, idx2.offsets)


def _plans(index, builder_cls, rng_seed, n_sub=6, nq=12, nprobe=4, k=5):
    """The same sequence of plans for either package's PlanBuilder."""
    rng = np.random.default_rng(rng_seed)
    q = index.flat[rng.choice(index.flat.shape[0], nq, replace=False)]
    probes = index.probe_order(q, nprobe)
    plans = []
    for s in range(n_sub):
        b = builder_cls()
        for i in range(nq):
            b.add(q[i], probes[i, : 2 + s % 3], k=k)
        plans.append(b.build())
    return plans


def test_hybrid_engine_matches_jax_engine(small_index):
    kw = dict(cache_capacity=8, update_interval=1, transit_substages=1)
    jeng = JaxHybrid(small_index, kernel_impl="ref", **kw)
    teng = HybridRetrievalEngine(_port_index(small_index), device="cpu", **kw)
    n0 = ivf_scan.plain_calls
    for jp, tp in zip(_plans(small_index, JaxPlanBuilder, 3),
                      _plans(small_index, PlanBuilder, 3)):
        jb, tb = jeng.search_plan(jp), teng.search_plan(tp)
        np.testing.assert_array_equal(tb.ids, jb.ids)
        fin = np.isfinite(jb.dists)
        assert np.array_equal(fin, np.isfinite(tb.dists))
        np.testing.assert_allclose(tb.dists[fin], jb.dists[fin], **F32)
    assert ivf_scan.plain_calls > n0          # the device path ran
    assert teng.cache.stats.hits > 0
    assert dataclasses.asdict(teng.cache.stats) == dataclasses.asdict(jeng.cache.stats)
    assert teng.upload_stats == jeng.upload_stats
    assert teng.upload_stats["full"] == 1 and teng.upload_stats["delta"] >= 1


def test_hybrid_device_mirror_tracks_host_slab(small_index):
    """After swaps, the device tensor equals the host slab (delta uploads by
    index_copy_ land in the right slots)."""
    eng = HybridRetrievalEngine(_port_index(small_index), cache_capacity=4,
                                update_interval=1, transit_substages=0, device="cpu")
    for plan in _plans(small_index, PlanBuilder, 5, n_sub=8):
        eng.search_plan(plan)
    slab, valid = eng._device_arrays()
    np.testing.assert_array_equal(slab.numpy(), eng._slab)
    np.testing.assert_array_equal(valid.numpy(), eng._slab_valid)

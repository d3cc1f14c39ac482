"""Similarity-aware search optimization (paper §4.3, C4).

Implements the three locality-based observations and the machinery that
exploits them:

  O1  results of v' are often inside the *larger top-k'* results of v
      -> keep a per-request local cache of k'=20 results; answer v' from the
         cache when it is conclusive;
  O2  results of v' tend to live in H_v (clusters that held v's results)
      -> search H_v ∩ C' first;
  O3  results of v' tend to live in C_v ∩ C' (clusters probed for v)
      -> search (C_v - H_v) ∩ C' second, the rest last.

Cluster reordering feeds the triangle-inequality early-termination check in
the scheduler: once the running kth distance is below the lossless lower
bound of every remaining cluster, the stage stops early (paper Fig. 9b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.retrieval.ivf import IVFIndex, TopK


@dataclasses.dataclass
class LocalCache:
    """Per-request history of the previous retrieval stage."""

    k_prime: int = 20
    query_vec: Optional[np.ndarray] = None
    dists: Optional[np.ndarray] = None  # (k',) of previous search
    ids: Optional[np.ndarray] = None  # (k',)
    home_clusters: Optional[set] = None  # H_v
    probed_clusters: Optional[set] = None  # C_v

    def update(self, query_vec: np.ndarray, topk: TopK, index: IVFIndex,
               probed: list[int]) -> None:
        self.query_vec = np.asarray(query_vec, np.float32)
        self.dists = topk.dists.copy()
        self.ids = topk.ids.copy()
        valid = topk.ids[topk.ids >= 0]
        self.home_clusters = set(int(c) for c in doc_clusters(index, valid))
        self.probed_clusters = set(int(c) for c in probed)

    @property
    def empty(self) -> bool:
        return self.query_vec is None


def doc_clusters(index: IVFIndex, doc_ids: np.ndarray) -> np.ndarray:
    """Map doc ids -> cluster ids via the flat-store offsets."""
    return index.doc_cluster(np.asarray(doc_ids, np.int64))


@dataclasses.dataclass
class ReorderPlan:
    order: list[int]
    n_home: int  # |H_v ∩ C'| prefix length
    n_probed: int  # |(C_v - H_v) ∩ C'| middle length


def reorder_clusters(candidates: list[int], cache: LocalCache) -> ReorderPlan:
    """O2/O3 ordering: H_v∩C' then (C_v − H_v)∩C' then the rest; ties keep
    the centroid-distance order the candidate list arrived in."""
    if cache is None or cache.empty:
        return ReorderPlan(list(candidates), 0, 0)
    hv = cache.home_clusters or set()
    cv = cache.probed_clusters or set()
    first = [c for c in candidates if c in hv]
    second = [c for c in candidates if c not in hv and c in cv]
    rest = [c for c in candidates if c not in hv and c not in cv]
    return ReorderPlan(first + second + rest, len(first), len(second))


def answer_from_cache(
    cache: LocalCache, query_vec: np.ndarray, k: int, *, delta: float
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """O1: try to answer v' from v's larger-top-k' cache.

    Conclusive iff d(v, v') <= delta AND the cache holds at least k entries
    whose distance to v' (recomputed exactly against cached vectors is not
    possible — the cache stores distances to v, so we use the ball bound):
    every cached entry within  d_i(v) + 2*delta  of the kth is accepted.
    The caller treats a None as "fall through to real search".
    """
    if cache.empty or cache.ids is None:
        return None
    dvv = float(np.linalg.norm(cache.query_vec - query_vec))
    if dvv > delta:
        return None
    valid = cache.ids >= 0
    if valid.sum() < k:
        return None
    # conservative: require a margin between kth and (k'-th) cached distance
    d = np.sqrt(np.maximum(cache.dists[valid], 0.0))
    if d.shape[0] <= k or d[-1] - d[k - 1] < 2.0 * dvv:
        return None
    return cache.dists[valid][:k], cache.ids[valid][:k]


def early_termination_possible(
    index: IVFIndex,
    query_vec: np.ndarray,
    remaining: list[int],
    topk: TopK,
) -> bool:
    """Lossless stop: kth running distance below the lower bound of every
    remaining cluster (centroid distance minus cluster radius, squared)."""
    if not remaining or not np.isfinite(topk.kth):
        return False
    lb = index.cluster_lower_bound(query_vec[None], np.asarray(remaining))
    return bool(topk.kth <= lb.min())


def heuristic_termination_possible(
    index: IVFIndex,
    query_vec: np.ndarray,
    remaining: list[int],
    topk: TopK,
    *,
    margin: float = 0.85,
) -> bool:
    """Centroid-margin approximate stop: terminate when every remaining
    cluster's centroid distance already exceeds margin x the running kth
    distance.  Only meaningful for centroid-ordered scans; reordered scans
    use the patience stop below."""
    if not remaining or not np.isfinite(topk.kth):
        return False
    cd = index.centroid_dists(query_vec[None])[0][np.asarray(remaining)]
    return bool(cd.min() > margin * topk.kth)


def patience_termination(no_improve: int, searched: int, k: int,
                         *, patience: int = 3, min_searched: int = 2) -> bool:
    """ANNS adaptive stop (what the paper's Fig. 9b exploits): terminate when
    the running top-k has not improved for ``patience`` consecutive clusters.
    Similarity reordering surfaces the home clusters first, so the
    no-improvement streak starts earlier — that is precisely the "earlier
    termination" mechanism; recall cost is measured in bench_similarity."""
    return searched >= max(min_searched, 1) and no_improve >= patience


# ---------------------------------------------------------------------------
# Observation statistics (reproduces paper Fig. 9a on any workload)
# ---------------------------------------------------------------------------


def observation_stats(
    index: IVFIndex,
    prev_q: np.ndarray,
    next_q: np.ndarray,
    *,
    k: int = 1,
    k_prime: int = 20,
    nprobe: int = 32,
) -> dict:
    """For a (v, v') pair: does each locality observation hold?"""
    dv, iv = index.search(prev_q[None], nprobe, k_prime)
    dn, inn = index.search(next_q[None], nprobe, k)
    truth = set(int(i) for i in inn[0] if i >= 0)
    o1 = truth.issubset(set(int(i) for i in iv[0] if i >= 0))
    hv = set(int(c) for c in doc_clusters(index, iv[0][iv[0] >= 0]))
    tc = set(int(c) for c in doc_clusters(index, inn[0][inn[0] >= 0]))
    o2 = tc.issubset(hv)
    cv = set(int(c) for c in index.probe_order(prev_q[None], nprobe)[0])
    cn = set(int(c) for c in index.probe_order(next_q[None], nprobe)[0])
    o3 = tc.issubset(cv & cn)
    return {"o1": o1, "o2": o2, "o3": o3}

"""Shared cluster-popularity tracking + popularity-aware replication.

The per-worker EMA histogram in ``serving/dispatch.py`` only sees the probes
*one worker* served, so at N workers each worker's picture of cluster
hotness is a 1/N sample and the affinity policy serialises every hot cluster
on whichever worker saw it first.  :class:`PopularityTracker` is the shared
source of truth that supersedes it: one globally decayed cluster-probe
histogram, recorded at dispatch time by the dispatcher and consulted by

* the dispatcher's replica-aware routing (via :class:`ReplicaMap`);
* the hot-cluster device cache's refresh ranking
  (``HotClusterCache(shared_tracker=...)``), so residency decisions see the
  whole pool's traffic instead of execution-order artifacts.

:class:`ReplicaMap` turns the histogram into *replica sets*: clusters above
the hotness cut become resident on (or routable to) ``replication_factor``
distinct workers, so concurrent sub-stages probing a hot cluster spread
across its replica holders instead of piling onto a single owner.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from repro_torch.retrieval.hotcache import AccessTracker


class PopularityTracker(AccessTracker):
    """Global decayed cluster-probe histogram (one per serving pool).

    Recording happens at *dispatch* (`RetrievalDispatcher.note_dispatch`);
    decay ticks once per scheduler assembly cycle, owned by the scheduler —
    consumers (cache refresh, replica map) must never tick it themselves.
    """

    def __init__(self, n_clusters: int, decay: float = 0.98):
        super().__init__(n_clusters, decay=decay)

    def hot_clusters(self, n_hot: int) -> np.ndarray:
        """Top ``n_hot`` clusters by decayed probe count, hottest first,
        trimmed to those actually observed (freq > 0)."""
        top = self.top(max(int(n_hot), 0))
        return top[self.freq[top] > 0.0]


class ReplicaMap:
    """cid -> tuple of replica-holder worker ids, for hot clusters only.

    Refreshed either from the shared tracker (pure placement replication:
    rank-spread assignment) or from the device cache's actual replicated
    residency when a hybrid engine with ``replication > 1`` is attached.
    Clusters with fewer than two holders are *not* mapped — single-owner
    routing stays with the configured dispatch policy.
    """

    def __init__(self, num_workers: int, factor: int, *,
                 hot_fraction: float = 0.1):
        self.num_workers = max(1, int(num_workers))
        self.factor = max(1, int(factor))
        self.hot_fraction = float(hot_fraction)
        self._owners: dict[int, tuple[int, ...]] = {}

    @property
    def n_replicated(self) -> int:
        return len(self._owners)

    def owners(self, cid: int) -> Optional[tuple[int, ...]]:
        return self._owners.get(int(cid))

    def owners_for(self, clusters: Iterable[int]) -> set[int]:
        """Union of replica holders over the sub-stage's hot clusters."""
        out: set[int] = set()
        for c in clusters:
            o = self._owners.get(int(c))
            if o:
                out.update(o)
        return out

    def covering_holders(self, clusters: Iterable[int]) -> set[int]:
        """Workers holding a replica of *every* cluster in the part — the
        failover candidates that can serve an orphaned shard part whole.
        Empty whenever any cluster is unreplicated (the dead owner was its
        only copy)."""
        common: Optional[set[int]] = None
        for c in clusters:
            o = self._owners.get(int(c))
            cover = set(o) if o else set()
            common = cover if common is None else (common & cover)
            if not common:
                return set()
        return common or set()

    # ---------------------------------------------------------------- refresh
    def refresh_from_tracker(self, tracker: PopularityTracker) -> None:
        """Rank-spread assignment: the i-th hottest cluster is owned by
        workers ``{(i + j) % num_workers}`` — deterministic, and adjacent
        hot clusters land on disjoint primaries."""
        if self.factor < 2 or self.num_workers < 2:
            self._owners = {}
            return
        n_hot = max(1, int(self.hot_fraction * tracker.freq.shape[0]))
        rf = min(self.factor, self.num_workers)
        self._owners = {
            int(cid): tuple(sorted((rank + j) % self.num_workers
                                   for j in range(rf)))
            for rank, cid in enumerate(tracker.hot_clusters(n_hot))
        }

    def refresh_from_cache(self, cache) -> None:
        """Mirror the device cache's replicated residency: a cluster with
        visible copies on several workers' slabs is routable to any of them.
        Owner derivation and transit visibility live in the cache's
        ``replica_owners`` accessor — this is a pure mirror."""
        owners: dict[int, tuple[int, ...]] = {}
        for cid in cache.replica_slots():
            held = tuple(cache.replica_owners(cid))
            if len(held) > 1:
                owners[int(cid)] = held
        self._owners = owners

"""Cross-request coordination layer: shared state between concurrent requests.

HedraRAG's §4.3 similarity machinery (LocalCache answers, O2/O3 cluster
reordering, triangle-bound early termination) is per-request, and its §4.4
skewness observation is exploited per-worker (device residency, dispatch
affinity).  This package lifts both to the *inter-request* scale the paper
measures but serves one request at a time:

===================  =====================================================
component            paper anchor
===================  =====================================================
``GlobalCache``      §4.3 O1-O3 across requests: a bounded, LRU +
(globalcache.py)     popularity-evicted semantic cache of completed
                     searches ``(query_vec, top-k', H_v, C_v)``.  Entries
                     duck-type ``LocalCache``, so the existing
                     ``answer_from_cache`` conclusive check and
                     ``reorder_clusters`` seeding apply unchanged — cold
                     requests inherit hot requests' history.
``FusionPass``       §4.3 similarity + §4.4 skew applied to the in-flight
(dedup.py)           query stream: near-identical retrieval sub-stages in
                     one wavefront fuse into a single executing group
                     (exact-duplicate byte-hash fast path; cosine
                     threshold for near-duplicates) whose merged top-k
                     rows fan out to every subscriber, so N lookalike
                     requests charge one segment scan instead of N.
``PopularityTracker``  §4.4 cluster skew as a *shared* signal: one global
``ReplicaMap``       decayed probe histogram superseding the per-worker
(popularity.py)      EMA, driving popularity-aware replication — hot
                     clusters become resident on multiple workers' device
                     slabs and the dispatcher routes to any replica
                     holder instead of serialising on a single owner.
===================  =====================================================

All features are off by default (``SchedulerConfig.global_cache_size=0``,
``dedup_threshold=0.0``, ``replication_factor=1``); disabled, the serving
loop is bit-identical to the uncoordinated path.
"""
from __future__ import annotations

from repro_torch.crossreq.dedup import FusionPass, FusionStats
from repro_torch.crossreq.globalcache import GlobalCache, GlobalCacheEntry, GlobalCacheStats
from repro_torch.crossreq.popularity import PopularityTracker, ReplicaMap

__all__ = [
    "CrossRequestCoordinator",
    "FusionPass",
    "FusionStats",
    "GlobalCache",
    "GlobalCacheEntry",
    "GlobalCacheStats",
    "PopularityTracker",
    "ReplicaMap",
]


class CrossRequestCoordinator:
    """Facade owning the cross-request state for one scheduler instance.

    Built by ``WavefrontScheduler`` when any crossreq knob is enabled; the
    scheduler threads the tracker/replica map into the dispatcher and (when
    a hybrid engine is attached) into the hot-cluster cache.
    """

    def __init__(self, config, index, num_workers: int):
        self.global_cache = (
            GlobalCache(config.global_cache_size)
            if config.global_cache_size > 0 else None
        )
        self.fusion = (
            FusionPass(config.dedup_threshold)
            if config.dedup_threshold > 0.0 else None
        )
        self.tracker = PopularityTracker(index.n_clusters)
        self.replicas = (
            ReplicaMap(num_workers, config.replication_factor)
            if (config.replication_factor > 1 and num_workers > 1) else None
        )
        self._replicated_cache = None  # hybrid cache mirrored by the map

    def attach_cache(self, cache, num_workers: int, factor: int) -> None:
        """Extend an existing hot-cluster cache with replicated residency and
        point its refresh ranking at the shared tracker."""
        cache.replication = max(1, int(factor))
        cache.num_owners = max(1, int(num_workers))
        cache.shared_tracker = self.tracker
        self._replicated_cache = cache

    def tick(self) -> None:
        """Once per assembly cycle: decay the shared histogram and refresh
        the replica map from its source of truth (device residency when a
        replicated cache is attached, tracker ranking otherwise)."""
        self.tracker.tick()
        if self.replicas is None:
            return
        if self._replicated_cache is not None:
            self.replicas.refresh_from_cache(self._replicated_cache)
        else:
            self.replicas.refresh_from_tracker(self.tracker)

    def report(self) -> dict:
        out: dict = {"replicated_clusters": (
            self.replicas.n_replicated if self.replicas is not None else 0)}
        if self.global_cache is not None:
            out["global_cache"] = self.global_cache.report()
        if self.fusion is not None:
            out["dedup"] = self.fusion.report()
        return out

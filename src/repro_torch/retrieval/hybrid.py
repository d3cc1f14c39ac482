"""Hybrid host/device retrieval engine (paper §4.4, Fig. 11).

Per sub-stage the engine receives a :class:`~repro_torch.retrieval.plan.RetrievalPlan`
— a structure-of-arrays batch of (query, cluster) probes spanning requests.
The plan's segment table is partitioned at *cluster* granularity: segments
whose cluster is resident in the device hot cache are packed into QB-aligned
query-groups and scanned by the fused CUDA kernel (its plain PyTorch
version for CPU tensors); the rest run on the host GEMM path.  Both paths merge into the plan's shared
``BatchTopK`` scoreboard, and the caller treats their runtimes as overlapped
(they execute on different resources in the real system).

Device-slab maintenance is incremental: cluster swaps stage tiles into the
host slab and mark the slot dirty; the device tensor is then *delta
updated* with one batched ``index_copy_`` per sub-stage instead of
re-uploading the whole slab (``stats()['uploads']`` reports full vs delta traffic).
Clusters larger than the tile length are refused residency (they would be
silently truncated on the device) and stay on the host path.

The legacy per-item ``search_substage`` API is kept as a thin adapter over
the plan executor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ivf_scan import ivf_scan
from repro_torch.retrieval.hotcache import HotClusterCache, capacity_from_bytes
from repro_torch.retrieval.ivf import IVFIndex, TopK
from repro_torch.retrieval.plan import BatchTopK, RetrievalPlan, plan_from_work

# Queries per device work group.  The CUDA kernel keeps QB x 4 partial dot
# products per lane in registers (4 rows at a time), so 8 keeps that at 32
# registers; a smaller group would split a cluster probed by more queries
# into more groups, each reading the cluster's rows again.
QB = 8


@dataclasses.dataclass
class SubstageTiming:
    host_us: float = 0.0
    device_us: float = 0.0
    n_host_items: int = 0
    n_device_items: int = 0

    @property
    def overlapped_us(self) -> float:
        return max(self.host_us, self.device_us)


class HybridRetrievalEngine:
    def __init__(
        self,
        index: IVFIndex,
        *,
        cache_capacity: int = 0,
        tile_len: int = 0,
        update_interval: int = 50,
        transit_substages: int = 2,
        device="cuda",
        topk_default: int = 10,
        replication: int = 1,
        num_owners: int = 1,
        shared_tracker=None,
    ):
        self.index = index
        self.device = resolve_device(device)
        self.topk_default = topk_default
        sizes = index.cluster_sizes()
        self.tile_len = tile_len or max(128, int(-(-sizes.max() // 128) * 128))
        self.cache_capacity = cache_capacity
        if cache_capacity:
            self._slab = np.zeros(
                (cache_capacity, self.tile_len, index.dim), np.float32
            )
            self._slab_ids = np.full((cache_capacity, self.tile_len), -1, np.int64)
            self._slab_valid = np.zeros((cache_capacity,), np.int32)
            self._slot_cid = np.full((cache_capacity,), -1, np.int64)
        self.cache = HotClusterCache(
            index.n_clusters,
            cache_capacity,
            update_interval=update_interval,
            transit_substages=transit_substages,
            loader=self._load_cluster if cache_capacity else None,
            replication=replication,
            num_owners=num_owners,
            shared_tracker=shared_tracker,
        )
        self._device_slab = None  # lazily mirrored device tensors
        self._dirty_slots: set[int] = set()  # staged but not yet delta-uploaded
        self._qbuf = np.zeros((0, QB, index.dim), np.float32)  # persistent
        self.upload_stats = {"full": 0, "delta": 0, "delta_slots": 0}

    # ----------------------------------------------------------- shard mode
    def enable_sharding(self, shard_owner, num_owners: int) -> None:
        """Partition the device slab by cluster ownership: worker ``w`` owns
        slots ``s`` with ``s % num_owners == w`` and only its shard's
        clusters (plus crossreq hot-cluster replicas) are staged there, so
        each worker's resident set shrinks ~``num_owners`` x versus the
        pool-global slab.  Must run before any cluster is staged."""
        self.cache.set_shard_owner(shard_owner, num_owners)

    @property
    def sharded(self) -> bool:
        return self.cache.shard_owner is not None

    # ------------------------------------------------------------- cache load
    def _load_cluster(self, cid: int, slot: int) -> bool:
        """Stage cluster ``cid`` into slab ``slot``; refuse oversized ones.

        A cluster larger than ``tile_len`` cannot be represented on the
        device without truncation (which would silently change top-k vs the
        host path), so residency is refused and the cache keeps it host-side.
        """
        lo, hi = int(self.index.offsets[cid]), int(self.index.offsets[cid + 1])
        m = hi - lo
        if m > self.tile_len:
            return False
        self._slab[slot, :] = 0.0
        self._slab[slot, :m] = self.index.flat[lo:hi]
        self._slab_ids[slot, :] = -1
        self._slab_ids[slot, :m] = self.index.ids[lo:hi]
        self._slab_valid[slot] = m
        self._slot_cid[slot] = cid
        self._dirty_slots.add(int(slot))  # delta-upload on next device use
        return True

    def _device_arrays(self):
        """Device copy of the slab, maintained by per-slot delta uploads."""
        if self._device_slab is None:
            self._device_slab = (
                torch.from_numpy(self._slab).to(self.device, copy=True),
                torch.from_numpy(self._slab_valid).to(self.device, copy=True),
            )
            self.upload_stats["full"] += 1
            self._dirty_slots.clear()
        elif self._dirty_slots:
            slots = np.fromiter(sorted(self._dirty_slots), np.int64)
            ds, dv = self._device_slab
            at = torch.from_numpy(slots).to(self.device)
            ds.index_copy_(0, at, torch.from_numpy(self._slab[slots]).to(self.device))
            dv.index_copy_(0, at, torch.from_numpy(self._slab_valid[slots]).to(self.device))
            self.upload_stats["delta"] += 1
            self.upload_stats["delta_slots"] += int(slots.size)
            self._dirty_slots.clear()
        return self._device_slab

    # ---------------------------------------------------------------- search
    def search_plan(
        self,
        plan: RetrievalPlan,
        *,
        resident: Optional[np.ndarray] = None,
        timing: Optional[SubstageTiming] = None,
        owner: Optional[int] = None,
    ) -> BatchTopK:
        """Execute one plan: device path for resident-cluster segments, host
        path for the rest, both merging into the item scoreboard.

        ``resident`` is the residency snapshot (bool per cluster) taken when
        the sub-stage was *dispatched*; passing it keeps the executed
        partition consistent with the charged one even if swaps landed in
        between.  Segments whose snapshot said device but whose cluster has
        since been swapped out fall back to the host path (counted in
        ``cache.stats.stale_fallbacks``).

        ``owner`` (shard mode) restricts the device path to the executing
        worker's slot partition: slot resolution goes through
        ``cache.slot_on_owner`` so a cluster resident only on *another*
        worker's slab takes this worker's host path.
        """
        out = BatchTopK.empty(plan.n_items, plan.k)
        # records accesses; hit/miss stats and live residency are both
        # owner-filtered in shard mode, matching the executed partition
        cur = self.cache.lookup_batch(plan.cluster_ids, owner=owner)
        if resident is None:
            # per-segment residency from the per-item lookup (items of a
            # segment share one cluster, so its first is representative)
            seg_dev = cur[plan.seg_order[plan.seg_bounds[:-1]]]
        else:
            seg_dev = resident[plan.seg_cluster]
        host_segs: list[int] = []
        dev_segs: list[int] = []
        dev_slots: dict[int, int] = {}
        for s in range(plan.n_segments):
            if not seg_dev[s]:
                host_segs.append(s)
                continue
            cid = int(plan.seg_cluster[s])
            if owner is None:
                slot = self.cache._resident.get(cid)
            else:
                slot = self.cache.slot_on_owner(cid, owner)
            if slot is None or self._slot_cid[slot] != cid:
                # swapped out between dispatch and execution
                self.cache.stats.stale_fallbacks += int(
                    plan.segment_rows(s).size)
                host_segs.append(s)
            else:
                dev_segs.append(s)
                dev_slots[s] = int(slot)

        if dev_segs:
            t0 = time.perf_counter()
            n_dev = self._device_scan(plan, dev_segs, out, dev_slots)
            if timing is not None:
                timing.device_us = (time.perf_counter() - t0) * 1e6
                timing.n_device_items = n_dev
        if host_segs:
            t0 = time.perf_counter()
            self.index.scan_segments(plan, np.asarray(host_segs, np.int64), out)
            if timing is not None:
                timing.host_us = (time.perf_counter() - t0) * 1e6
                timing.n_host_items = int(
                    sum(plan.segment_rows(s).size for s in host_segs))

        self.cache.end_substage()
        return out

    def search_substage(
        self, work: Sequence[tuple[np.ndarray, int, TopK]]
    ) -> tuple[list[TopK], SubstageTiming]:
        """Legacy per-item API: adapt the work list to a plan and execute."""
        timing = SubstageTiming()
        if not work:
            self.cache.end_substage()  # empty sub-stages still tick the clock
            return [], timing
        plan = plan_from_work(work)
        res = plan.finalize(self.search_plan(plan, timing=timing))
        return (
            [res.group_topk(g, int(plan.group_k[g]))
             for g in range(plan.n_groups)],
            timing,
        )

    # ------------------------------------------------------------ device path
    def _query_groups(self, n: int) -> np.ndarray:
        """Persistent pre-packed query-group buffer (grown geometrically)."""
        if self._qbuf.shape[0] < n:
            cap = max(n, 2 * self._qbuf.shape[0], 8)
            self._qbuf = np.zeros((cap, QB, self.index.dim), np.float32)
        return self._qbuf

    def _device_scan(self, plan: RetrievalPlan, dev_segs, out: BatchTopK,
                     dev_slots: Optional[dict] = None) -> int:
        """Pack resident segments into (G, QB, d) groups + fused scan, then
        one vectorized scatter-merge of all member rows.  ``dev_slots``
        (shard mode) carries the per-segment slot resolved on the executing
        worker's partition; without it the primary slot is used."""
        slab, valid = self._device_arrays()
        k = min(plan.k, self.tile_len)
        g_slots: list[int] = []
        g_rows: list[np.ndarray] = []
        for s in dev_segs:
            if dev_slots is not None and s in dev_slots:
                slot = dev_slots[s]
            else:
                slot = int(self.cache.slot_of(int(plan.seg_cluster[s])))
            rows = plan.segment_rows(s)
            for ofs in range(0, rows.size, QB):
                g_slots.append(slot)
                g_rows.append(rows[ofs: ofs + QB])
        G = len(g_slots)
        qbuf = self._query_groups(G)
        qbuf[:G] = 0.0
        for g, rows in enumerate(g_rows):
            qbuf[g, : rows.size] = plan.queries[rows]
        slots_arr = np.asarray(g_slots, np.int32)
        dists, idx = ivf_scan(
            torch.from_numpy(qbuf[:G]).to(self.device),
            torch.from_numpy(slots_arr).to(self.device), slab, valid, k)
        # .cpu() waits for the kernel: RealBackend.search_charged times
        # around this call, so without the sync it would time only the launch
        dists = dists.cpu().numpy()  # (G, QB, k)
        idx = idx.cpu().numpy()
        # local row -> doc id for all groups at once
        sid = self._slab_ids[slots_arr]  # (G, L)
        ids = np.take_along_axis(
            sid, np.maximum(idx, 0).reshape(G, -1), axis=1).reshape(idx.shape)
        ids = np.where(idx >= 0, ids, -1)
        # one scatter-merge over the real (non-padded) member rows
        counts = [r.size for r in g_rows]
        rows_flat = np.concatenate(g_rows)
        sel_g = np.repeat(np.arange(G), counts)
        sel_r = np.concatenate([np.arange(c) for c in counts])
        out.merge_rows(rows_flat, dists[sel_g, sel_r], ids[sel_g, sel_r])
        return int(rows_flat.size)

    # ---------------------------------------------------------------- stats
    def resident_mask(self, owner: Optional[int] = None) -> np.ndarray:
        """Residency snapshot for dispatch-time charging (bool per cluster);
        ``owner`` restricts it to one worker's slot partition (shard mode)."""
        return self.cache.resident_mask(owner)

    def replica_owners(self, cid: int) -> list[int]:
        """Workers holding a staged replica of ``cid`` (crossreq routing)."""
        return self.cache.replica_owners(cid)

    def stats(self) -> dict:
        per_owner = (self.cache.per_owner_resident()
                     if self.cache.num_owners > 1 else {})
        return {
            "sharded": self.sharded,
            "per_owner_resident": per_owner,
            "hit_rate": self.cache.stats.hit_rate,
            "hits": self.cache.stats.hits,
            "misses": self.cache.stats.misses,
            "swaps": self.cache.stats.swaps,
            "oversized_rejects": self.cache.stats.oversized_rejects,
            "stale_fallbacks": self.cache.stats.stale_fallbacks,
            "replica_loads": self.cache.stats.replica_loads,
            "replicated_clusters": len(self.cache.replicated_ids),
            "uploads": dict(self.upload_stats),
            "skew": self.cache.tracker.skewness_report(),
        }


def engine_from_memory_budget(
    index: IVFIndex,
    cache_bytes: int,
    **kw,
) -> HybridRetrievalEngine:
    sizes = index.cluster_sizes()
    tile_len = max(128, int(-(-sizes.max() // 128) * 128))
    cap = capacity_from_bytes(cache_bytes, tile_len, index.dim)
    cap = min(cap, index.n_clusters)
    return HybridRetrievalEngine(index, cache_capacity=cap, tile_len=tile_len, **kw)

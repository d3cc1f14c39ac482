"""Partial device index cache with asynchronous updates (paper §4.4, C6).

The accelerator cannot hold the whole IVF index next to LM weights and KV
cache, but cluster access is heavily skewed (paper Fig. 8: top 20% of
clusters -> ~69% of compute).  We therefore cache the top-``gc`` hottest
clusters in device memory:

* access frequencies are tracked with an exponential moving average so the
  hot set adapts as workloads shift;
* the cached set is refreshed every ``update_interval`` sub-stages (50 in the
  paper) — *not* on demand — to avoid host<->device link contention;
* swaps are asynchronous: a cluster being loaded is "in transit" for
  ``transit_substages`` sub-stages, during which searches for it fall back to
  the host path (exactly the paper's rule);
* Eq. (2) picks the KV-cache size (and therefore the cache budget) by
  balancing generation vs retrieval throughput.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Access tracking
# ---------------------------------------------------------------------------


class AccessTracker:
    """Per-cluster EMA access frequency."""

    def __init__(self, n_clusters: int, decay: float = 0.98):
        self.freq = np.zeros(n_clusters, np.float64)
        self.decay = decay
        self.total_accesses = 0

    def record(self, cluster_ids: np.ndarray | list[int]) -> None:
        ids = np.asarray(cluster_ids, np.int64)
        np.add.at(self.freq, ids, 1.0)
        self.total_accesses += int(ids.size)

    def tick(self) -> None:
        self.freq *= self.decay

    def top(self, n: int) -> np.ndarray:
        n = min(n, self.freq.size)
        part = np.argpartition(-self.freq, n - 1)[:n]
        return part[np.argsort(-self.freq[part], kind="stable")]

    def skewness_report(self, fractions=(0.05, 0.1, 0.2, 0.5)) -> dict:
        """Fraction of accesses covered by the top-x%% clusters (Fig. 8)."""
        srt = np.sort(self.freq)[::-1]
        tot = max(srt.sum(), 1e-9)
        cum = np.cumsum(srt) / tot
        return {
            f"top_{int(f*100)}pct": float(cum[max(int(len(srt) * f) - 1, 0)])
            for f in fractions
        }


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    transit_blocked: int = 0
    swaps: int = 0
    updates: int = 0
    # clusters refused residency because they exceed the device tile length
    # (they would be silently truncated on the device path)
    oversized_rejects: int = 0
    # items whose snapshot said device but whose cluster was swapped out
    # between dispatch and execution (host fallback, counted for honesty)
    stale_fallbacks: int = 0
    # extra (non-primary) replica copies staged for hot clusters when
    # popularity-aware replication is enabled
    replica_loads: int = 0

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


class HotClusterCache:
    """Device-resident cache of the hottest IVF clusters.

    ``loader(cid, slot)`` is called when a cluster becomes resident; in the
    real engine it stages the cluster tile into the cache slab (the device
    mirror is delta-updated lazily).  A loader may *refuse* a cluster by
    returning ``False`` — e.g. one larger than the device tile, which would
    be silently truncated — in which case the slot is released and the
    cluster stays on the host path (counted in ``stats.oversized_rejects``).
    Loads become *visible* only ``transit_substages`` sub-stages later.

    Cross-request extensions (``repro_torch.crossreq``): ``replication > 1``
    stages the hottest clusters into multiple slots on distinct owner
    workers (slot *s* belongs to worker ``s % num_owners``) so the
    dispatcher can route hot-cluster sub-stages to any replica holder; a
    ``shared_tracker`` (the pool-global :class:`PopularityTracker`)
    supersedes the cache's own access EMA as the refresh ranking source.
    Both default off, leaving behaviour identical to the single-owner cache.
    """

    def __init__(
        self,
        n_clusters: int,
        capacity: int,
        *,
        update_interval: int = 50,
        transit_substages: int = 2,
        decay: float = 0.98,
        loader: Optional[Callable[[int, int], None]] = None,
        replication: int = 1,
        num_owners: int = 1,
        shared_tracker=None,
    ):
        self.tracker = AccessTracker(n_clusters, decay=decay)
        self.capacity = int(capacity)
        self.update_interval = update_interval
        self.transit_substages = transit_substages
        self.loader = loader
        self.replication = max(1, int(replication))
        self.num_owners = max(1, int(num_owners))
        # ticked by its owner (the scheduler), never by this cache
        self.shared_tracker = shared_tracker
        self.stats = CacheStats()
        # shard-mode ownership (set via set_shard_owner before any staging):
        # cluster ``c``'s primary copy may only be staged into a slot owned
        # by worker ``shard_owner[c]`` — each worker's slab partition holds
        # only its own shard (plus replicated hot clusters), which is what
        # cuts per-worker residency ~N x under index sharding
        self.shard_owner: Optional[np.ndarray] = None
        self._resident: dict[int, int] = {}  # cid -> primary slot
        self._replica_slots: dict[int, list[int]] = {}  # cid -> all slots
        self._transit: dict[int, int] = {}  # cid -> substages remaining
        # per-slot transit for *extra* replica copies: the primary stays
        # visible while a new replica pays the same staging latency
        self._slot_transit: dict[int, int] = {}
        self._refused: set[int] = set()  # loader-refused (e.g. oversized)
        self._free_slots = list(range(self.capacity))
        self._substage = 0

    def set_shard_owner(self, owner: np.ndarray, num_owners: int) -> None:
        """Enable shard-mode slot ownership: primary copies are constrained
        to their owning worker's slot partition.  Must be configured before
        any cluster is staged — re-partitioning a populated slab would
        silently orphan resident tiles."""
        if self._resident:
            raise RuntimeError(
                "set_shard_owner must be called before any cluster is staged")
        self.shard_owner = np.asarray(owner, np.int64)
        self.num_owners = max(1, int(num_owners))

    # ------------------------------------------------------------------ query
    def is_resident(self, cid: int) -> bool:
        return cid in self._resident and cid not in self._transit

    def slot_of(self, cid: int) -> int:
        return self._resident[cid]

    def lookup(self, cid: int) -> bool:
        """Record an access and return device-residency (False -> host path)."""
        self.tracker.record([cid])
        if cid in self._transit:
            self.stats.transit_blocked += 1
            self.stats.misses += 1
            return False
        if cid in self._resident:
            self.stats.hits += 1
            return True
        self.stats.misses += 1
        return False

    def lookup_batch(self, cids: np.ndarray,
                     owner: Optional[int] = None) -> np.ndarray:
        """Vectorized ``lookup``: record all accesses at once and return a
        per-item residency bool (False -> host path).  Equivalent to calling
        ``lookup`` per item, without the Python loop over the tracker.
        ``owner`` (shard mode) counts hits against the executing worker's
        slot partition — a cluster resident only on another worker's slab
        is a miss for this worker, matching the executed partition."""
        ids = np.asarray(cids, np.int64)
        self.tracker.record(ids)
        if not self._resident and not self._transit:
            self.stats.misses += int(ids.size)
            return np.zeros(ids.shape, bool)
        mask = self.resident_mask(owner)
        res = mask[ids]
        transit = np.isin(ids, np.fromiter(self._transit, np.int64))
        self.stats.transit_blocked += int(transit.sum())
        self.stats.hits += int(res.sum())
        self.stats.misses += int(ids.size - res.sum())
        return res

    def resident_mask(self, owner: Optional[int] = None) -> np.ndarray:
        """Snapshot of device residency as a bool array over all clusters.
        Taken at sub-stage *assembly* time by the backends so that the
        charged duration and the executed host/device partition agree even
        when swaps land in between (see SimBackend.search_charged).

        With ``owner`` given (shard mode), a cluster counts as resident only
        when a *visible* staged copy lives on that worker's slot partition —
        workers see their own shard (plus replicated hot clusters), not the
        pool-global slab."""
        mask = np.zeros(self.tracker.freq.shape[0], bool)
        if owner is None:
            for cid in self._resident:
                if cid not in self._transit:
                    mask[cid] = True
            return mask
        for cid in self._replica_slots:
            if any(s % self.num_owners == owner
                   for s in self._visible_slots(cid)):
                mask[cid] = True
        return mask

    def slot_on_owner(self, cid: int, owner: int) -> Optional[int]:
        """Visible staged slot of ``cid`` on worker ``owner``'s partition,
        or None — shard-mode slot resolution for the device scan path."""
        for s in self._visible_slots(cid):
            if s % self.num_owners == owner:
                return s
        return None

    def per_owner_resident(self) -> dict[int, int]:
        """Visible staged copies per owner worker — the per-worker device
        residency figure the shard-mode benchmarks/tests report."""
        out = {w: 0 for w in range(self.num_owners)}
        for cid in self._replica_slots:
            for s in self._visible_slots(cid):
                out[s % self.num_owners] += 1
        return out

    @property
    def resident_ids(self) -> list[int]:
        return [c for c in self._resident if c not in self._transit]

    def _visible_slots(self, cid: int) -> list[int]:
        """Visible staged slots of ``cid`` (primary first): none while the
        primary load is in transit, and individual replica copies in slot
        transit are excluded.  The single home of the visibility rule —
        every residency/routing accessor builds on it."""
        if cid in self._transit:
            return []
        return [s for s in self._replica_slots.get(cid, ())
                if s not in self._slot_transit]

    def replica_slots(self) -> dict[int, list[int]]:
        """cid -> *visible* staged slots (primary first).  Clusters whose
        primary load is still in transit, and individual replica copies in
        slot transit, are excluded — visibility semantics live in
        ``_visible_slots``, not in the callers."""
        return {
            cid: self._visible_slots(cid)
            for cid in self._replica_slots
            if cid not in self._transit
        }

    def replica_owners(self, cid: int) -> list[int]:
        """Distinct owner workers holding a *visible* copy of ``cid``."""
        return sorted({s % self.num_owners
                       for s in self._visible_slots(cid)})

    @property
    def replicated_ids(self) -> list[int]:
        """Visible clusters staged on two or more distinct owners."""
        return [c for c in self._replica_slots
                if len(self.replica_owners(c)) > 1]

    # ------------------------------------------------------------------- tick
    def end_substage(self) -> None:
        """Advance one sub-stage: progress transits, maybe refresh hot set."""
        self._substage += 1
        done = []
        for cid in list(self._transit):
            self._transit[cid] -= 1
            if self._transit[cid] <= 0:
                done.append(cid)
        for cid in done:
            del self._transit[cid]
        for slot in list(self._slot_transit):
            self._slot_transit[slot] -= 1
            if self._slot_transit[slot] <= 0:
                del self._slot_transit[slot]
        self.tracker.tick()
        if self.capacity and self._substage % self.update_interval == 0:
            self._refresh()

    def _want_copies(self, ranked: list[int]) -> dict[int, int]:
        """Desired copies per cluster under the capacity budget: with
        replication the hottest ``capacity // (2*replication)`` clusters get
        ``replication`` copies (on distinct owners), the rest one.  Copies
        beyond the number of distinct owners add no routable holder, so the
        factor is clamped to ``num_owners``."""
        r = max(1, min(self.replication, self.num_owners))
        if r == 1:
            return {c: 1 for c in ranked[: self.capacity]}
        n_hot = max(1, self.capacity // (2 * r))
        want: dict[int, int] = {}
        budget = self.capacity
        for i, c in enumerate(ranked):
            n = min(r if i < n_hot else 1, budget)
            if n <= 0:
                break
            want[c] = n
            budget -= n
        return want

    def _take_slot(self, used_owners: set[int],
                   require_distinct: bool = False) -> Optional[int]:
        """Pop a free slot on an owner not yet holding a copy of the
        cluster (so replicas spread across workers).  With
        ``require_distinct`` (extra replica copies), returns None instead
        of falling back to a same-owner slot — such a copy would pin
        capacity without adding a routable holder."""
        if self.num_owners > 1 and used_owners:
            for i in range(len(self._free_slots) - 1, -1, -1):
                if self._free_slots[i] % self.num_owners not in used_owners:
                    return self._free_slots.pop(i)
            if require_distinct:
                return None
        return self._free_slots.pop()

    def _take_owner_slot(self, owner: int) -> Optional[int]:
        """Pop a free slot on exactly ``owner``'s partition (shard-mode
        primary staging), or None when that worker's slots are full."""
        for i in range(len(self._free_slots) - 1, -1, -1):
            if self._free_slots[i] % self.num_owners == owner:
                return self._free_slots.pop(i)
        return None

    def _refresh(self) -> None:
        self.stats.updates += 1
        # refused clusters (e.g. oversized for the device tile) are excluded
        # from candidacy so they are rejected at most once and the slot they
        # would pin goes to the next-hottest loadable cluster instead;
        # ranking comes from the pool-shared tracker when one is attached
        src = self.shared_tracker if self.shared_tracker is not None else self.tracker
        ranked = [int(c) for c in
                  src.top(self.capacity + len(self._refused))
                  if int(c) not in self._refused]
        want = self._want_copies(ranked)
        have = set(self._resident)
        evict = list(have - set(want))
        # evict first to free slots; eviction is instantaneous (drop only)
        for cid in evict:
            for slot in self._replica_slots.pop(cid, [self._resident[cid]]):
                self._free_slots.append(slot)
                self._slot_transit.pop(slot, None)
            self._resident.pop(cid)
            self._transit.pop(cid, None)
        # trim excess copies of clusters that cooled below the hot cut
        for cid, slots in self._replica_slots.items():
            keep = want.get(cid, 1)
            while len(slots) > keep:
                slot = slots.pop()
                self._free_slots.append(slot)
                self._slot_transit.pop(slot, None)
        # stage missing copies, hottest first (dict preserves ranked order)
        for cid, copies in want.items():
            slots = self._replica_slots.get(cid, [])
            fresh = cid not in have
            while len(slots) < copies:
                if not self._free_slots:
                    return
                owners = {s % self.num_owners for s in slots}
                if self.shard_owner is not None and not slots:
                    # shard mode: the primary copy must live on the owning
                    # worker's slot partition; a full partition keeps the
                    # cluster host-side this round (other shards' slots
                    # stay available to their own clusters)
                    slot = self._take_owner_slot(int(self.shard_owner[cid]))
                else:
                    slot = self._take_slot(owners, require_distinct=bool(slots))
                if slot is None:
                    break  # no eligible slot free: skip the copy
                if self.loader is not None and self.loader(cid, slot) is False:
                    # loader refused: release the slot, remember the refusal,
                    # keep the cluster on the host path permanently
                    self._free_slots.append(slot)
                    self._refused.add(cid)
                    self.stats.oversized_rejects += 1
                    break
                slots.append(slot)
                self._replica_slots[cid] = slots
                if fresh and len(slots) == 1:
                    self._resident[cid] = slot
                    self._transit[cid] = self.transit_substages
                else:
                    # extra replica: the primary stays visible, the new copy
                    # pays the same staging latency before it is routable
                    self._slot_transit[slot] = self.transit_substages
                    self.stats.replica_loads += 1
                self.stats.swaps += 1


# ---------------------------------------------------------------------------
# Eq. (2): KV-cache vs index-cache memory split
# ---------------------------------------------------------------------------


def plan_memory_split(
    total_bytes: int,
    *,
    t_gen: Callable[[int, float], float],
    t_ret: Callable[[float], float],
    rps_g: float,
    rps_r: float,
    kv_candidates: list[int],
) -> tuple[int, int]:
    """argmax_{KV_size} min{ T_G(KV_size, rps_G), T_R(rps_R) }   (paper Eq. 2)

    Returns (kv_bytes, index_cache_bytes).  ``t_gen``/``t_ret`` come from
    offline characterisation (benchmarks/bench_engines.py writes the tables).
    Ties break toward the *smallest* KV size — leftover memory is worth more
    as index cache.
    """
    tr = t_ret(rps_r)
    best = None
    for kv in sorted(c for c in kv_candidates if c <= total_bytes):
        score = min(t_gen(kv, rps_g), tr)
        if best is None or score > best[0] + 1e-12:
            best = (score, kv)
    if best is None:
        kv = min(kv_candidates)
        return kv, max(total_bytes - kv, 0)
    return best[1], total_bytes - best[1]


def capacity_from_bytes(cache_bytes: int, tile_len: int, dim: int,
                        dtype_bytes: int = 4) -> int:
    """How many cluster tiles fit in the index-cache budget."""
    per = tile_len * dim * dtype_bytes
    return max(cache_bytes // per, 0) if per else 0

"""Global semantic cache shared across requests (paper §4.3, lifted to §4.4's
inter-request scale).

``LocalCache`` exploits *intra*-request similarity: v' of one request is
answered or accelerated from the same request's previous v.  At production
concurrency the same locality holds *across* requests — near-identical
queries arrive from different users — so the GlobalCache keeps a bounded,
eviction-managed pool of completed searches
``(query_vec, top-k', home clusters H_v, probed clusters C_v)`` that any
request can consult at sub-stage assembly:

* **exact hit** (same query bytes, same nprobe): the entry's top-k is the
  answer — the conclusive-answer fast path;
* **near hit** within the O1 ball bound: answered through the existing
  ``answer_from_cache`` triangle-bound check (entries duck-type
  ``LocalCache``, so the per-request machinery applies unchanged);
* **seed hit**: on an inconclusive near miss the nearest entry's H_v/C_v
  seed O2/O3 cluster reordering, so a cold request inherits a hot request's
  search history and terminates earlier.

Eviction is LRU + popularity-weighted: the victim maximises
``age / (1 + hits)``, so briefly-idle hot entries outlive one-shot cold ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.similarity import answer_from_cache, doc_clusters
from repro_torch.retrieval.ivf import TopK


def merge_unique(a: TopK, b: TopK, k: int) -> TopK:
    """Merge two top-k lists *of the same query* into one width-``k`` list
    with distinct doc ids (``TopK.merge`` alone would duplicate the shared
    seed prefix when accumulating wide rows across sub-stages)."""
    av, bv = a.ids >= 0, b.ids >= 0
    d = np.concatenate([a.dists[av], b.dists[bv]])
    i = np.concatenate([a.ids[av], b.ids[bv]])
    order = np.argsort(d, kind="stable")
    d, i = d[order], i[order]
    _, first = np.unique(i, return_index=True)
    keep = np.sort(first)[:k]
    out = TopK.empty(k)
    out.dists[: keep.size] = d[keep]
    out.ids[: keep.size] = i[keep]
    return out


@dataclasses.dataclass
class GlobalCacheEntry:
    """One completed search; field names duck-type ``LocalCache`` so
    ``answer_from_cache`` / ``reorder_clusters`` consume entries directly."""

    query_vec: np.ndarray
    dists: np.ndarray
    ids: np.ndarray
    home_clusters: set
    probed_clusters: set
    nprobe: int
    key: bytes
    hits: int = 0
    last_used: int = 0

    @property
    def empty(self) -> bool:
        return False


@dataclasses.dataclass
class GlobalCacheStats:
    lookups: int = 0
    exact_hits: int = 0
    near_answers: int = 0
    seed_hits: int = 0
    inserts: int = 0
    refreshes: int = 0
    evictions: int = 0


class GlobalCache:
    """Bounded cross-request semantic cache (see module docstring)."""

    def __init__(
        self,
        capacity: int,
        *,
        exact_eps: float = 1e-6,
        answer_delta_frac: float = 0.15,
        seed_delta_frac: float = 0.6,
    ):
        if capacity <= 0:
            raise ValueError("GlobalCache capacity must be positive")
        self.capacity = int(capacity)
        self.exact_eps = float(exact_eps)
        self.answer_delta_frac = float(answer_delta_frac)
        self.seed_delta_frac = float(seed_delta_frac)
        self.stats = GlobalCacheStats()
        self._entries: list[Optional[GlobalCacheEntry]] = [None] * self.capacity
        self._by_key: dict[bytes, int] = {}  # query-bytes key -> slot
        self._vecs: Optional[np.ndarray] = None  # (capacity, d) stacked
        self._valid = np.zeros(self.capacity, bool)
        self._tick = 0

    def __len__(self) -> int:
        return int(self._valid.sum())

    @staticmethod
    def _key(query_vec: np.ndarray, nprobe: int) -> bytes:
        return (np.asarray(query_vec, np.float32).tobytes()
                + np.array([nprobe], np.int64).tobytes())

    def _touch(self, slot: int) -> None:
        ent = self._entries[slot]
        ent.hits += 1
        ent.last_used = self._tick

    # ------------------------------------------------------------------ reads
    def nearest(self, query_vec: np.ndarray) -> Optional[tuple[GlobalCacheEntry, float]]:
        """Nearest entry by L2; returns (entry, distance) or None."""
        if self._vecs is None or not self._valid.any():
            return None
        q = np.asarray(query_vec, np.float32)
        idx = np.flatnonzero(self._valid)
        d = ((self._vecs[idx] - q[None, :]) ** 2).sum(axis=1)
        j = int(np.argmin(d))
        return self._entries[int(idx[j])], float(np.sqrt(max(d[j], 0.0)))

    def consult(
        self, query_vec: np.ndarray, k: int, nprobe: int, *,
        allow_answer: bool = True, allow_seed: bool = True,
    ) -> tuple[Optional[tuple[np.ndarray, np.ndarray]],
               Optional[GlobalCacheEntry]]:
        """One lookup, both outcomes: ``(answer, seed_entry)``.

        The conclusive-answer check (exact-key fast path, then the O1 ball
        bound against the nearest entry) and the H_v/C_v seed fall-back
        share a single O(capacity x d) nearest scan.  At most one of the
        two results is non-None.
        """
        if not allow_answer and not allow_seed:
            return None, None  # nothing can hit: skip the scan entirely
        self._tick += 1
        self.stats.lookups += 1
        q = np.asarray(query_vec, np.float32)
        if allow_answer:
            slot = self._by_key.get(self._key(q, nprobe))
            if slot is not None:
                ent = self._entries[slot]
                valid = ent.ids >= 0
                if int(valid.sum()) >= k:
                    self._touch(slot)
                    self.stats.exact_hits += 1
                    return ((ent.dists[valid][:k].copy(),
                             ent.ids[valid][:k].copy()), None)
        near = self.nearest(q)
        if near is None:
            return None, None
        ent, dvv = near
        if allow_answer:
            if dvv <= self.exact_eps and ent.nprobe == nprobe:
                valid = ent.ids >= 0
                if int(valid.sum()) >= k:
                    self._touch(self._by_key[ent.key])
                    self.stats.exact_hits += 1
                    return ((ent.dists[valid][:k].copy(),
                             ent.ids[valid][:k].copy()), None)
            # a shallower search's entry is not the true top-k' for this
            # request's probe depth; the ball bound would overstate recall
            if ent.nprobe >= nprobe:
                hit = answer_from_cache(
                    ent, q, k,
                    delta=self.answer_delta_frac * float(np.linalg.norm(q)))
                if hit is not None:
                    self._touch(self._by_key[ent.key])
                    self.stats.near_answers += 1
                    return (hit[0].copy(), hit[1].copy()), None
        if allow_seed and dvv <= self.seed_delta_frac * float(np.linalg.norm(q)):
            self._touch(self._by_key[ent.key])
            self.stats.seed_hits += 1
            return None, ent
        return None, None

    def answer(self, query_vec: np.ndarray, k: int, nprobe: int
               ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Conclusive-answer check only; None -> fall through to search."""
        return self.consult(query_vec, k, nprobe, allow_seed=False)[0]

    def seed(self, query_vec: np.ndarray) -> Optional[GlobalCacheEntry]:
        """Nearest entry within the seed ball — its H_v/C_v feed O2/O3
        reordering for a request with no local history of its own."""
        return self.consult(query_vec, 1, 0, allow_answer=False)[1]

    # ----------------------------------------------------------------- writes
    def insert(self, query_vec: np.ndarray, topk: TopK, index,
               probed: list[int], nprobe: int) -> None:
        """Publish a completed search.  Same-key inserts refresh in place;
        otherwise the LRU/popularity victim is evicted."""
        self._tick += 1
        q = np.asarray(query_vec, np.float32)
        if self._vecs is None:
            self._vecs = np.zeros((self.capacity, q.shape[0]), np.float32)
        key = self._key(q, nprobe)
        valid_ids = topk.ids[topk.ids >= 0]
        home = set(int(c) for c in doc_clusters(index, valid_ids))
        slot = self._by_key.get(key)
        hits_keep = 0
        if slot is None:
            free = np.flatnonzero(~self._valid)
            if free.size:
                slot = int(free[0])
            else:
                slot = self._evict()
            self.stats.inserts += 1
        else:
            # refresh: keep popularity, replace payload
            self.stats.refreshes += 1
            hits_keep = self._entries[slot].hits
        ent = GlobalCacheEntry(
            query_vec=q.copy(),
            dists=topk.dists.copy(),
            ids=topk.ids.copy(),
            home_clusters=home,
            probed_clusters=set(int(c) for c in probed),
            nprobe=int(nprobe),
            key=key,
            hits=hits_keep,
            last_used=self._tick,
        )
        self._entries[slot] = ent
        self._by_key[key] = slot
        self._vecs[slot] = q
        self._valid[slot] = True

    def _evict(self) -> int:
        """Victim = max age / (1 + hits): plain LRU tempered by popularity."""
        best_slot, best_score = 0, -1.0
        for slot in np.flatnonzero(self._valid):
            ent = self._entries[int(slot)]
            score = (self._tick - ent.last_used) / (1.0 + ent.hits)
            if score > best_score:
                best_slot, best_score = int(slot), score
        victim = self._entries[best_slot]
        del self._by_key[victim.key]
        self._entries[best_slot] = None
        self._valid[best_slot] = False
        self.stats.evictions += 1
        return best_slot

    # ------------------------------------------------------------------ stats
    def report(self) -> dict:
        s = self.stats
        return {
            "size": len(self),
            "capacity": self.capacity,
            "lookups": s.lookups,
            "exact_hits": s.exact_hits,
            "near_answers": s.near_answers,
            "seed_hits": s.seed_hits,
            "inserts": s.inserts,
            "refreshes": s.refreshes,
            "evictions": s.evictions,
        }

"""In-flight query dedup/fusion across a wavefront (paper §4.4's skewness
observation applied to the *query* stream).

At production concurrency, N near-identical retrieval stages from different
users routinely sit in the same wavefront.  Without coordination each one
charges its own segment scans.  The fusion pass clusters pending retrieval
sub-stages by query similarity and fuses lookalikes into one executing
group:

* the first request of a group (in SLO-slack order) is the **leader** — its
  sub-stages dispatch normally and carry ``fanout = 1 + n_subscribers`` so
  backends can account the charge once per fused group;
* **subscribers** are parked (never assembled); when the leader's stage
  completes, its merged top-k rows fan out to every subscriber and their
  stages complete at the same instant.

Two matching tiers:

* **exact** — identical query bytes + (k, nprobe): byte-hash fast path.
  The subscriber receives the leader's answer for *the same query*; under
  result-preserving settings (lossless early termination, cache answers
  off) that is bit-identical to executing the subscriber independently —
  verified in ``bench_crossreq`` and ``tests/test_crossreq.py``.  Under
  the default heuristic early termination, leader and independent
  execution are both approximations of the same reference search (their
  searched prefixes may differ), so the fused answer is one of those
  approximations, not a bitwise replay of the other;
* **near** — cosine similarity >= ``threshold`` within the same (k, nprobe)
  bucket: the subscriber is answered *from the leader's result* with the
  same tolerance semantics as an O1 cache answer (returned distances are to
  the leader's query; the error is bounded by the leader-subscriber query
  distance via the triangle inequality).  The subscriber's LocalCache
  records the leader's query vector with those distances, keeping the next
  round's ball bound sound.

A leader stays matchable while its stage is in flight, so duplicates
arriving a few cycles late still fuse instead of re-scanning.  Fusion runs
in the hedra sub-stage assembly path only — the coarse async/sequential
baselines model systems without cross-request coordination.

Matching is keyed on **stage-typed signatures** (core/stages.py FusionSig):
each registered StageSpec describes its own equivalence class — exact key
bytes, a parameter bucket, and an optional unit vector for near matching —
so rerank/rewrite/compress stages dedup through the identical machinery as
retrieval, and stage kinds never collide (the kind prefixes the key and
bucket).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.stages import FusionSig


@dataclasses.dataclass
class FusionStats:
    exact_subscribed: int = 0
    near_subscribed: int = 0
    leaders_registered: int = 0
    groups_fused: int = 0  # leader completions that had >= 1 subscriber
    fanout_total: int = 0


@dataclasses.dataclass
class _Leader:
    rid: int
    req: object
    key: bytes
    bucket: tuple  # ("<kind>", *stage params), e.g. ("retrieval", k, nprobe)
    unit_vec: Optional[np.ndarray]


def _retrieval_sig(req) -> FusionSig:
    """Default signature for a legacy retrieval stage (callers that pass no
    explicit sig — direct FusionPass use outside the scheduler)."""
    from repro_torch.core import stages

    return stages.spec("retrieval").fusion_signature(None, req)


class FusionPass:
    """Clusters pending stage work by signature similarity and tracks
    leader -> subscriber groups while the leader's stage is in flight."""

    def __init__(self, threshold: float):
        if not 0.0 < threshold <= 1.0:
            raise ValueError("dedup threshold must be in (0, 1]")
        self.threshold = float(threshold)
        self.stats = FusionStats()
        self._leaders: dict[int, _Leader] = {}  # rid -> leader record
        self._by_key: dict[bytes, int] = {}  # exact stage key -> leader rid
        # bucket -> {rid: unit query vec}; near matches only compare within
        # a bucket so fused answers keep the subscriber's stage parameters
        self._buckets: dict[tuple, dict[int, np.ndarray]] = {}
        self._subs: dict[int, list[tuple[object, str]]] = {}

    @property
    def n_inflight_leaders(self) -> int:
        return len(self._leaders)

    # ---------------------------------------------------------------- matching
    def try_subscribe(self, req, sig: Optional[FusionSig] = None, *,
                      allow_near: bool) -> Optional[str]:
        """Attach ``req``'s fresh stage to an in-flight leader with the same
        signature.  Returns 'exact' / 'near', or None when no leader
        matches."""
        if sig is None:
            sig = _retrieval_sig(req)
        lead = self._by_key.get(sig.key)
        if lead is not None and lead != req.request_id:
            self._subs[lead].append((req, "exact"))
            self.stats.exact_subscribed += 1
            return "exact"
        if not allow_near or self.threshold >= 1.0 or sig.unit_vec is None:
            return None
        bucket = self._buckets.get(sig.bucket)
        if not bucket:
            return None
        q = np.asarray(sig.unit_vec, np.float64)
        rids = [r for r in bucket if r != req.request_id]
        if not rids:
            return None
        mat = np.stack([bucket[r] for r in rids])
        cos = mat @ q
        j = int(np.argmax(cos))
        if float(cos[j]) < self.threshold:
            return None
        self._subs[rids[j]].append((req, "near"))
        self.stats.near_subscribed += 1
        return "near"

    def register_leader(self, req, sig: Optional[FusionSig] = None) -> None:
        """Make ``req`` the executing leader for its signature; later
        lookalikes subscribe until the stage completes."""
        rid = req.request_id
        if rid in self._leaders:
            return
        if sig is None:
            sig = _retrieval_sig(req)
        self._leaders[rid] = _Leader(rid, req, sig.key, sig.bucket,
                                     sig.unit_vec)
        self._by_key.setdefault(sig.key, rid)
        if sig.unit_vec is not None:
            self._buckets.setdefault(sig.bucket, {})[rid] = sig.unit_vec
        self._subs.setdefault(rid, [])
        self.stats.leaders_registered += 1

    def fanout(self, rid: int) -> int:
        """1 + current subscriber count (1 when ``rid`` is not a leader)."""
        return 1 + len(self._subs.get(rid, ()))

    # -------------------------------------------------------------- completion
    def complete_leader(self, rid: int) -> list[tuple[object, str]]:
        """Leader's stage finished: drop the group and hand back the
        subscribers for fan-out.  No-op (empty list) for non-leaders."""
        lead = self._leaders.pop(rid, None)
        if lead is None:
            return []
        if self._by_key.get(lead.key) == rid:
            del self._by_key[lead.key]
        bucket = self._buckets.get(lead.bucket)
        if bucket is not None:
            bucket.pop(rid, None)
            if not bucket:
                del self._buckets[lead.bucket]
        subs = self._subs.pop(rid, [])
        if subs:
            self.stats.groups_fused += 1
            self.stats.fanout_total += len(subs)
        return subs

    # ------------------------------------------------------------------ stats
    def report(self) -> dict:
        s = self.stats
        return {
            "exact_subscribed": s.exact_subscribed,
            "near_subscribed": s.near_subscribed,
            "leaders_registered": s.leaders_registered,
            "groups_fused": s.groups_fused,
            "fanout_total": s.fanout_total,
            "inflight_leaders": self.n_inflight_leaders,
        }

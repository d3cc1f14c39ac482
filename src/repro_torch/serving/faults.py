"""Deterministic fault injection for the serving pool.

A :class:`FaultPlan` is a *seeded script* of everything that goes wrong in a
chaos run: worker crashes pinned to virtual-clock instants, stall windows
that inflate service time (and, when severe, pause the worker's heartbeats),
and transient per-task failures drawn from a counter-indexed seeded stream.
Because every draw is a pure function of ``(plan.seed, worker_id, counter)``
and the wavefront scheduler itself is deterministic, the *same plan replays
the same run event-for-event* — the property the chaos tests pin.

The plan is injected through the backend timing hooks
(``SimBackend.fault_latency``) and consulted by the worker lifecycle
registry (``serving/lifecycle.py``) to drive heartbeat-based state
transitions; the recovery machinery lives in ``core/wavefront.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# a stall must slow the worker at least this much before its heartbeat
# thread is considered wedged too (milder latency spikes keep heartbeating
# and are covered by per-task timeouts instead of SUSPECT transitions)
HEARTBEAT_STALL_FACTOR = 3.0


@dataclasses.dataclass(frozen=True)
class WorkerCrash:
    """Worker ``wid`` dies at ``at_us`` (virtual clock) and never returns.
    Work in flight at the crash is lost; results of jobs that would have
    completed after the crash are fenced (discarded) even if the scheduler
    only detects the death later through missed heartbeats."""

    wid: int
    at_us: float


@dataclasses.dataclass(frozen=True)
class StallWindow:
    """Worker ``wid`` runs ``factor``x slower for jobs dispatched inside
    ``[start_us, end_us)``.  Severe stalls (factor >=
    ``HEARTBEAT_STALL_FACTOR``) also pause the worker's heartbeats for the
    duration, so the lifecycle registry marks it SUSPECT."""

    wid: int
    start_us: float
    end_us: float
    factor: float = 4.0

    @property
    def pauses_heartbeats(self) -> bool:
        return self.factor >= HEARTBEAT_STALL_FACTOR


@dataclasses.dataclass
class FaultPlan:
    """A replayable chaos script over the retrieval-worker pool."""

    crashes: list = dataclasses.field(default_factory=list)
    stalls: list = dataclasses.field(default_factory=list)
    # probability that one dispatched task unit (sub-stage plan group /
    # scatter part / stage batch) fails transiently and must be retried
    transient_fail_prob: float = 0.0
    seed: int = 0

    # ------------------------------------------------------------- queries
    def crash_at(self, wid: int) -> Optional[float]:
        """Earliest crash instant scripted for ``wid`` (None = never)."""
        times = [c.at_us for c in self.crashes if c.wid == int(wid)]
        return min(times) if times else None

    def crashed_by(self, wid: int, t_us: float) -> bool:
        c = self.crash_at(wid)
        return c is not None and t_us >= c

    def stall_factor(self, wid: int, t_us: float) -> float:
        """Service-time multiplier for work dispatched to ``wid`` at
        ``t_us`` (max over active windows; 1.0 = no stall)."""
        f = 1.0
        for w in self.stalls:
            if w.wid == int(wid) and w.start_us <= t_us < w.end_us:
                f = max(f, float(w.factor))
        return f

    def heartbeat_pause_start(self, wid: int, t_us: float) -> Optional[float]:
        """Start of the severe stall window wedging ``wid``'s heartbeats at
        ``t_us`` (None when heartbeats are flowing)."""
        start = None
        for w in self.stalls:
            if (w.wid == int(wid) and w.pauses_heartbeats
                    and w.start_us <= t_us < w.end_us):
                start = w.start_us if start is None else min(start, w.start_us)
        return start

    def transient_fault(self, wid: int, seq: int) -> bool:
        """Deterministic per-dispatch failure draw: the ``seq``-th unit ever
        dispatched (a scheduler-maintained counter) fails iff the seeded
        stream for ``(seed, wid, seq)`` says so — same seed, same run, same
        failures."""
        if self.transient_fail_prob <= 0.0:
            return False
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7919, int(wid), int(seq)]))
        return bool(rng.random() < self.transient_fail_prob)

    def change_times(self) -> list:
        """Every instant the plan's state can change (crash instants, stall
        window edges), ascending — the lifecycle registry folds these into
        the scheduler's event clock."""
        ts = {float(c.at_us) for c in self.crashes}
        for w in self.stalls:
            ts.add(float(w.start_us))
            ts.add(float(w.end_us))
        return sorted(ts)

    @property
    def is_empty(self) -> bool:
        return (not self.crashes and not self.stalls
                and self.transient_fail_prob <= 0.0)

    def describe(self) -> dict:
        return {
            "seed": int(self.seed),
            "crashes": [(int(c.wid), float(c.at_us)) for c in self.crashes],
            "stalls": [(int(w.wid), float(w.start_us), float(w.end_us),
                        float(w.factor)) for w in self.stalls],
            "transient_fail_prob": float(self.transient_fail_prob),
        }

    # --------------------------------------------------------- constructors
    @classmethod
    def random(cls, seed: int, n_workers: int, horizon_us: float, *,
               crash_frac: float = 0.25, stall_rate: float = 0.5,
               stall_len_us: float = 300_000.0, stall_factor: float = 6.0,
               transient_prob: float = 0.0) -> "FaultPlan":
        """A seeded random chaos script.  ``round(crash_frac * n_workers)``
        workers crash (choice of victim and instant is seeded), capped at
        ``n_workers - 1`` so the pool is never fully destroyed and
        whole-index failover always has a landing spot; stall windows arrive
        per-worker with probability ``stall_rate``, and transient failures
        fire with ``transient_prob``."""
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), 4099]))
        n_workers = max(1, int(n_workers))
        crashes = []
        n_crashes = min(max(0, n_workers - 1),
                        int(round(crash_frac * n_workers)))
        victims = [int(w) for w in rng.permutation(n_workers)[:n_crashes]]
        for wid in victims:
            at = float(rng.uniform(0.1, 0.8) * horizon_us)
            crashes.append(WorkerCrash(wid=wid, at_us=at))
        stalls = []
        for wid in range(n_workers):
            if rng.random() < stall_rate:
                start = float(rng.uniform(0.0, 0.7) * horizon_us)
                length = float(rng.uniform(0.5, 1.5) * stall_len_us)
                factor = float(rng.uniform(2.0, stall_factor))
                stalls.append(StallWindow(wid=wid, start_us=start,
                                          end_us=start + length,
                                          factor=factor))
        return cls(crashes=crashes, stalls=stalls,
                   transient_fail_prob=float(transient_prob), seed=int(seed))

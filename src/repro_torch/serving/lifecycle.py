"""Worker lifecycle: registration, heartbeats, drain/rebind, failure states.

The serving pool's control plane (the register/heartbeat/drain/rebind shape
of the astraflow worker-scheduler exemplar, adapted to the virtual event
clock): every retrieval worker is tracked by a :class:`WorkerRegistry` with
explicit states

    JOINING -> HEALTHY <-> SUSPECT -> DEAD
                  |                    ^
                  v                    |
               DRAINING  (rebind) -----+--> back to HEALTHY

* **JOINING** — registered, first heartbeat pending (promotion is immediate
  on the registration heartbeat; the state exists so timelines record the
  join).
* **HEALTHY** — heartbeating; eligible for new work.
* **SUSPECT** — heartbeats missed for ``suspect_after_us``: no *new* work,
  in-flight work is hedged (duplicate dispatch, first result wins).  A
  resumed heartbeat returns the worker to HEALTHY.
* **DRAINING** — operator-initiated leave: finishes in-flight work, takes
  no new work; ``rebind`` returns it to the pool.
* **DEAD** — heartbeats missed for ``dead_after_us`` (crash, or a wedge so
  long it is indistinguishable from one).  Terminal for fault-driven
  deaths while the underlying fault persists; in-flight work is recovered
  by the scheduler and any late results are fenced (discarded).

Heartbeats are *virtual*: with no fault plan a live worker's heartbeat is
always fresh, so with all knobs off nothing ever transitions and the
serving path is bit-identical to the pre-lifecycle loop.  A
``serving.faults.FaultPlan`` freezes heartbeats at a crash instant or
inside a severe stall window, and ``tick(now, plan)`` turns the resulting
gaps into state transitions at deterministic virtual-clock instants (the
scheduler folds ``next_transition_us`` into its event list).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.ownership import owned_by

JOINING = "joining"
HEALTHY = "healthy"
SUSPECT = "suspect"
DRAINING = "draining"
DEAD = "dead"

STATES = (JOINING, HEALTHY, SUSPECT, DRAINING, DEAD)


@dataclasses.dataclass
class WorkerHealth:
    wid: int
    state: str = JOINING
    last_heartbeat_us: float = 0.0
    registered_us: float = 0.0
    # [(t_us, state), ...] — every transition, for reports/tests
    timeline: list = dataclasses.field(default_factory=list)


@owned_by("scheduler")
class WorkerRegistry:
    """Health states for the retrieval-worker pool, driven by virtual-clock
    heartbeats.  The registry is always built (drain/rebind are operational
    APIs, not fault injection); with no fault plan and no drain calls every
    worker stays HEALTHY forever and the scheduler's behaviour is unchanged.
    """

    def __init__(self, num_workers: int, *,
                 heartbeat_interval_us: float = 50_000.0,
                 suspect_after_us: float = 150_000.0,
                 dead_after_us: float = 400_000.0,
                 external_heartbeats: bool = False):
        self.heartbeat_interval_us = float(heartbeat_interval_us)
        self.suspect_after_us = float(suspect_after_us)
        self.dead_after_us = float(dead_after_us)
        # external mode (wall-clock ingress): heartbeats come only from
        # explicit heartbeat() calls — the stored stamp is the truth and
        # real gaps drive SUSPECT/DEAD.  With a FaultPlan armed the plan
        # model stays authoritative either way, so chaos runs replay on the
        # virtual clock unchanged.
        self.external_heartbeats = bool(external_heartbeats)
        self.workers: dict[int, WorkerHealth] = {}
        self._n_not_healthy = 0
        # high-water mark of tick timestamps: wall-clock callers must never
        # run the gap math with a `now` behind one already processed
        self._last_tick_us = 0.0
        for _ in range(max(0, int(num_workers))):
            self.register(0.0)

    # --------------------------------------------------------------- states
    def state_of(self, wid: int) -> str:
        return self.workers[int(wid)].state

    def all_healthy(self) -> bool:
        """Fast path consulted every cycle: True iff no worker has ever left
        HEALTHY (the zero-fault, no-drain common case)."""
        return self._n_not_healthy == 0

    def can_schedule(self, wid: int) -> bool:
        """Eligible for *new* work this cycle."""
        return self.workers[int(wid)].state == HEALTHY

    def alive(self, wid: int) -> bool:
        return self.workers[int(wid)].state != DEAD

    def serving(self, wid: int) -> bool:
        """In the pool for new work now or after a SUSPECT recovery —
        i.e. not DEAD and not DRAINING.  Failover eligibility."""
        return self.workers[int(wid)].state not in (DEAD, DRAINING)

    def owner_serves(self, wid: int) -> bool:
        """A shard owner that is HEALTHY or SUSPECT keeps its parts (busy /
        possibly-recovering owners make parts *wait*, like a busy owner
        always has); DRAINING and DEAD owners hand their parts to failover."""
        return self.workers[int(wid)].state in (HEALTHY, SUSPECT)

    def alive_for_work(self) -> int:
        """Workers that can take new work now or eventually (not DEAD, not
        DRAINING).  Zero means retrieval-side work is stranded."""
        return sum(1 for w in self.workers.values()
                   if w.state not in (DEAD, DRAINING))

    def effective_pool_size(self) -> int:
        """Pool size the admission/slack cost model should divide by: the
        workers actually able to absorb new retrieval work."""
        return self.alive_for_work()

    # ----------------------------------------------------------- operations
    def _set_state(self, w: WorkerHealth, state: str, now: float) -> None:
        if w.state == state:
            return
        if w.state == HEALTHY:
            self._n_not_healthy += 1
        if state == HEALTHY:
            self._n_not_healthy -= 1
        w.state = state
        w.timeline.append((float(now), state))

    def register(self, now: float = 0.0, wid: Optional[int] = None) -> int:
        """Add a worker (JOINING, promoted by its registration heartbeat)."""
        if wid is None:
            wid = len(self.workers)
        wid = int(wid)
        if wid in self.workers:
            raise ValueError(f"worker {wid} already registered")
        w = WorkerHealth(wid=wid, registered_us=float(now),
                         last_heartbeat_us=float(now))
        w.timeline.append((float(now), JOINING))
        self._n_not_healthy += 1  # JOINING until the first heartbeat
        self.workers[wid] = w
        self.heartbeat(wid, now)
        return wid

    def heartbeat(self, wid: int, now: float) -> None:
        """Record a heartbeat stamped ``now``.  Wall-clock feeds must stamp
        with ``time.monotonic``-derived values (serving/ingress.py
        WallClock); the clamp below additionally guarantees that even a
        non-monotonic stamp can never regress ``last_heartbeat_us`` — a
        backward clock jump must not mark every worker SUSPECT at once."""
        w = self.workers[int(wid)]
        if w.state == DEAD:
            return  # fenced: a late heartbeat cannot resurrect a dead worker
        w.last_heartbeat_us = max(w.last_heartbeat_us, float(now))
        if w.state in (JOINING, SUSPECT):
            self._set_state(w, HEALTHY, now)

    def drain(self, wid: int, now: float) -> bool:
        """Operator-initiated leave: finish in-flight work, take no new
        work.  Returns False for a DEAD worker (nothing left to drain)."""
        w = self.workers[int(wid)]
        if w.state == DEAD:
            return False
        self._set_state(w, DRAINING, now)
        return True

    def rebind(self, wid: int, now: float) -> bool:
        """Reconnect a drained (or dead-and-replaced) worker to the pool.
        The worker re-enters through JOINING and is promoted by the rebind
        heartbeat.  Rebinding a worker whose scripted fault still holds
        (crash in the plan's past) is futile — the next tick re-kills it."""
        w = self.workers[int(wid)]
        self._set_state(w, JOINING, now)
        w.last_heartbeat_us = float(now)
        self.heartbeat(wid, now)
        return w.state == HEALTHY

    # ------------------------------------------------------------ heartbeat
    def _last_heartbeat(self, w: WorkerHealth, now: float, plan) -> float:
        """Virtual heartbeat model: a live worker's heartbeat is always
        fresh; a crash freezes it at the crash instant; a severe stall
        window freezes it at the window start (resuming when the window
        ends).  In external mode (no plan) the stored stamp — fed by
        ``heartbeat()`` from the wall-clock ingress — is the truth."""
        hb = float(now)
        if plan is not None:
            c = plan.crash_at(w.wid)
            if c is not None and now >= c:
                hb = min(hb, float(c))
            else:
                ps = plan.heartbeat_pause_start(w.wid, now)
                if ps is not None:
                    hb = min(hb, float(ps))
        elif self.external_heartbeats:
            hb = w.last_heartbeat_us
        return max(hb, w.registered_us)

    def tick(self, now: float, plan=None) -> list:
        """Fold heartbeat state at ``now`` into transitions.  Returns
        ``[(wid, old_state, new_state), ...]`` for every change.  The list
        is canonically wid-ordered — the scheduler's recovery path and the
        obs transition hooks consume it in order, so the order must come
        from the worker ids, not from registration history.

        Non-monotonic guard: ``now`` is clamped to the high-water mark of
        previous ticks, so a regressed timestamp (rebased wall clock,
        out-of-order drain) can neither compute negative gaps nor regress
        any ``last_heartbeat_us`` already recorded."""
        now = max(float(now), self._last_tick_us)
        self._last_tick_us = now
        out = []
        for w in sorted(self.workers.values(), key=lambda x: x.wid):
            if w.state == DEAD:
                continue  # terminal
            hb = self._last_heartbeat(w, now, plan)
            w.last_heartbeat_us = hb
            gap = float(now) - hb
            if w.state == DRAINING:
                # an operator-held worker can still crash; only the
                # DRAINING -> DEAD edge applies (no SUSPECT demotion, no
                # auto-promotion back to HEALTHY)
                if gap >= self.dead_after_us:
                    self._set_state(w, DEAD, now)
                    out.append((w.wid, DRAINING, DEAD))
                continue
            if gap >= self.dead_after_us:
                new = DEAD
            elif gap >= self.suspect_after_us:
                new = SUSPECT
            else:
                new = HEALTHY
            if new != w.state:
                old = w.state
                self._set_state(w, new, now)
                out.append((w.wid, old, new))
        return out

    def next_transition_us(self, now: float, plan) -> Optional[float]:
        """Earliest future instant any worker's state can change under
        ``plan`` — folded into the scheduler's event clock so detection
        happens exactly at crash+suspect_after / crash+dead_after etc.
        Conservative: may return an instant where nothing changes (the tick
        is then a no-op), never misses one where something does."""
        if plan is None:
            return None
        cands = []
        for w in self.workers.values():
            if w.state == DEAD:
                continue
            c = plan.crash_at(w.wid)
            if c is not None:
                for t in (c + self.suspect_after_us, c + self.dead_after_us):
                    if t > now:
                        cands.append(float(t))
            for win in plan.stalls:
                if w.wid != win.wid or not win.pauses_heartbeats:
                    continue
                for t in (win.start_us + self.suspect_after_us,
                          win.start_us + self.dead_after_us):
                    if now < t <= win.end_us + self.dead_after_us:
                        cands.append(float(t))
                if now < win.end_us:  # heartbeats resume: SUSPECT recovers
                    cands.append(float(win.end_us))
        return min(cands) if cands else None

    # --------------------------------------------------------------- report
    def state_counts(self) -> dict:
        """Worker population per lifecycle state, every state present (zeros
        included) so telemetry series keep a fixed label set."""
        out = {s: 0 for s in STATES}
        for w in self.workers.values():
            out[w.state] += 1
        return out

    def report(self) -> dict:
        by_state: dict[str, int] = {}
        for w in self.workers.values():
            by_state[w.state] = by_state.get(w.state, 0) + 1
        return {
            "num_workers": len(self.workers),
            "effective_pool_size": self.effective_pool_size(),
            "by_state": by_state,
            "workers": {
                w.wid: {
                    "state": w.state,
                    "last_heartbeat_us": w.last_heartbeat_us,
                    "registered_us": w.registered_us,
                    "timeline": [(float(t), s) for t, s in w.timeline],
                }
                for w in sorted(self.workers.values(), key=lambda x: x.wid)
            },
        }

"""Wall-clock ingress: the threaded serving front-end, with the virtual
clock as its deterministic replay oracle.

Producer threads (open-loop stream replayers, closed-loop clients, the
heartbeat pump) timestamp real arrivals off a monotonic :class:`WallClock`
and hand them to the scheduler thread through a single-lock bounded
:class:`IngressQueue` — the queue crossing is the lock behind the
``@handoff`` points PR 9's ownership markers enumerated.  The scheduler
thread runs :class:`ServingLoop`, which drains the queue in submission
order and applies each row against the existing virtual-clock machinery::

    producers ──put()──▶ IngressQueue ──drain()──▶ ServingLoop
      (wall stamps,          (single lock,            │ step(eff)
       monotonic)             bounded, MPSC)          │ submit/heartbeat
                                                      ▼
                                              WavefrontScheduler
                                              (virtual event clock)

**The oracle / replay contract.**  Every clock advance of a wall-clock run
comes from a recorded :class:`ArrivalTrace` row — arrivals, heartbeats,
re-admission attempts, and idle ticks all carry the effective virtual
instant they were applied at (``eff = max(wall stamp, event clock)``).
:func:`replay_trace` mechanically re-applies those rows on a fresh server
over the pure virtual clock, then drains; because the scheduler itself is
deterministic given (submission order, instants), the replay produces
**bit-identical per-request event fingerprints** (``Server.fingerprints``)
to the threaded run — including chaos runs with a ``FaultPlan`` armed.
The deterministic path stays the test oracle for the threaded one.

Closed-loop serving (:func:`closed_loop_serve`) runs ``spec.num_clients``
client threads that each submit, wait for the finish over a
:class:`Ticket`, think, and repeat, under a shared token budget
(``serving.workload.ClosedLoopSpec``).  Requests shed by the admission
controller are parked and re-admitted once the controller's backlog
estimate drops (``Server.admission_load``); re-admission attempts are
trace rows, so they replay exactly.

This module is the *only* place in the serving packages allowed to read
the wall clock (``repro-lint`` policy ``wallclock_ingress_paths``); obs
taps receive wall values as arguments and never read time themselves.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Iterable, Optional

from repro_torch.core.ownership import handoff, owned_by

# trace/queue row kinds (not stage kinds — scheduling never branches on
# these; they only select which Server entry point re-applies the row)
ARRIVAL = "arrival"
HEARTBEAT = "heartbeat"
READMIT = "readmit"
TICK = "tick"


class ReplayDivergence(RuntimeError):
    """A trace replay disagreed with the recorded run (admission outcome or
    request-id mismatch) — the determinism contract is broken."""


@owned_by("ingress")
class WallClock:
    """Monotonic wall clock mapped to virtual microseconds.

    ``time.monotonic`` never jumps backward on a rebased system clock (the
    reason ``time.time`` is banned here), and the high-water clamp makes
    even an injected non-monotonic source safe: ``now_us`` never regresses.
    ``speedup`` compresses wall time into virtual time (speedup 100 ->
    1 ms of wall is 100 000 virtual µs), which is how tests and benches
    run second-scale virtual workloads in milliseconds of wall time.
    """

    def __init__(self, speedup: float = 1.0,
                 source: Callable[[], float] = time.monotonic):
        self.speedup = float(speedup)
        self._source = source
        self._lock = threading.Lock()
        self._t0 = float(source())
        self._last_us = 0.0

    @handoff("*")
    def now_us(self) -> float:
        with self._lock:
            raw = (float(self._source()) - self._t0) * 1e6 * self.speedup
            self._last_us = max(self._last_us, raw)
            return self._last_us


@dataclasses.dataclass
class IngressItem:
    """One queue crossing: producer-stamped, drained by the scheduler
    thread.  ``seq`` is assigned under the queue lock, so it is the total
    submission order across all producer threads."""
    seq: int
    t_us: float
    kind: str
    workflow: str = ""
    text: str = ""
    wid: int = -1
    ticket: Optional["Ticket"] = None


@owned_by("ingress")
class IngressQueue:
    """Single-lock bounded MPSC queue between producer threads and the
    scheduler thread.  ``put`` blocks (bounded backpressure) while full;
    ``drain`` swaps the whole batch out under the lock, so the scheduler
    thread holds it for O(1) list moves, never while scheduling."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = max(1, int(maxsize))
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._items: list[IngressItem] = []
        self._seq = 0
        self._closed = False

    @handoff("*")
    def put(self, kind: str, t_us: float, *, workflow: str = "",
            text: str = "", wid: int = -1, ticket: Optional["Ticket"] = None,
            timeout_s: float = 30.0) -> Optional[int]:
        """Producer side: enqueue a row, blocking while the queue is full.
        Returns the assigned submission sequence number, or ``None`` when
        the queue closed (or stayed full past ``timeout_s``)."""
        deadline = time.monotonic() + float(timeout_s)
        with self._not_full:
            while len(self._items) >= self.maxsize and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._not_full.wait(remaining):
                    return None
            if self._closed:
                return None
            seq = self._seq
            self._seq += 1
            self._items.append(IngressItem(
                seq=seq, t_us=float(t_us), kind=kind, workflow=workflow,
                text=text, wid=int(wid), ticket=ticket))
            return seq

    @handoff("server")
    def drain(self) -> list[IngressItem]:
        """Scheduler side: take every queued row (submission order)."""
        with self._not_full:
            items, self._items = self._items, []
            if items:
                self._not_full.notify_all()
            return items

    @handoff("server")
    def pending_count(self) -> int:
        with self._lock:
            return len(self._items)

    @handoff("*")
    def close(self) -> None:
        with self._not_full:
            self._closed = True
            self._not_full.notify_all()


@owned_by("ingress")
class Ticket:
    """Completion handle handed back to a producer: resolved exactly once
    by the scheduler thread with ``"finished"`` or ``"shed"``."""

    def __init__(self):
        self._event = threading.Event()
        self.status = "pending"
        self.request_id: Optional[int] = None
        self.finish_us: Optional[float] = None
        self.latency_us: Optional[float] = None

    @handoff("server")
    def resolve(self, status: str, request_id: Optional[int] = None,
                finish_us: Optional[float] = None,
                latency_us: Optional[float] = None) -> None:
        self.status = status
        self.request_id = request_id
        self.finish_us = finish_us
        self.latency_us = latency_us
        self._event.set()

    @handoff("*")
    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self._event.wait(timeout_s)


@dataclasses.dataclass
class TraceRow:
    """One recorded event of a wall-clock run.  ``t_us`` is the *effective*
    virtual instant the row was applied at (never behind the event clock),
    so rows are non-decreasing in time and replay is a pure fold."""
    seq: int  # queue submission seq (-1 for loop-generated tick/readmit)
    t_us: float
    kind: str
    workflow: str = ""
    text: str = ""
    wid: int = -1
    ref: int = -1  # readmit rows: seq of the original shed arrival
    admitted: bool = True
    request_id: int = -1


@owned_by("server")
class ArrivalTrace:
    """The recorded arrival/heartbeat/readmit/tick log of a wall-clock run;
    JSON round-trips so traces can be archived and replayed offline."""

    SCHEMA_VERSION = 1

    def __init__(self, rows: Optional[list] = None):
        self.rows: list[TraceRow] = list(rows or [])

    def record(self, row: TraceRow) -> None:
        self.rows.append(row)

    def to_dict(self) -> dict:
        return {"schema_version": self.SCHEMA_VERSION,
                "rows": [dataclasses.asdict(r) for r in self.rows]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: dict) -> "ArrivalTrace":
        return cls(rows=[TraceRow(**r) for r in d.get("rows", ())])

    @classmethod
    def load(cls, path: str) -> "ArrivalTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class DurationTape:
    """FIFO log of the charges returned by a backend's measured surfaces
    (``gen_duration`` / ``search_charged`` / ``stage_charged``).

    The arrival trace pins every *external* clock advance of a wall run,
    but a measured backend (``RealBackend``) re-times its own execution
    on every pass, so a replayed replica drifts even when every arrival
    is reproduced exactly.  The tape closes that last hole: record mode
    appends each charge as it is measured; replay mode executes the same
    real compute (results and engine state stay live) but charges the
    *recorded* duration, which makes the replica's virtual timeline — and
    therefore its event fingerprints — bit-identical to the wall run.
    Scheduling is deterministic given arrivals + charges, so the replayed
    call sequence matches the recording; any mismatch in call kind, or an
    exhausted/unconsumed tape, raises :class:`ReplayDivergence` instead
    of silently diverging."""

    SCHEMA_VERSION = 1

    def __init__(self, rows: Optional[list] = None):
        self.rows: list = [(str(k), float(v)) for k, v in (rows or ())]
        self._idx = 0

    def record(self, kind: str, charge_us: float) -> None:
        self.rows.append((kind, float(charge_us)))

    def next(self, kind: str) -> float:
        if self._idx >= len(self.rows):
            raise ReplayDivergence(
                f"duration tape exhausted: replay issued backend call "
                f"#{self._idx} ({kind}) but only {len(self.rows)} were "
                f"recorded")
        k, charge = self.rows[self._idx]
        if k != kind:
            raise ReplayDivergence(
                f"duration tape call #{self._idx}: recorded kind {k!r}, "
                f"replay asked for {kind!r}")
        self._idx += 1
        return charge

    def rewind(self) -> None:
        self._idx = 0

    def remaining(self) -> int:
        return len(self.rows) - self._idx

    def to_dict(self) -> dict:
        return {"schema_version": self.SCHEMA_VERSION,
                "rows": [[k, v] for k, v in self.rows]}

    @classmethod
    def from_dict(cls, d: dict) -> "DurationTape":
        return cls(rows=d.get("rows", ()))


def tape_backend(backend, tape: DurationTape, *, mode: str):
    """Wrap a backend's measured charge surfaces with *tape* (in place).

    ``mode="record"`` appends every returned charge; ``mode="replay"``
    still runs the real compute (so results, engine KV state and cache
    residency evolve exactly as in the recording) but returns the taped
    charge, re-pointing the per-worker busy accounting at the taped value
    so ``worker_report`` matches too.  Wraps whatever is installed at
    call time, so launcher-style shims (e.g. an admission hook around
    ``gen_duration``) stay inside the tape in both modes.  Returns the
    backend."""
    if mode not in ("record", "replay"):
        raise ValueError(f"tape_backend mode must be record|replay: {mode!r}")
    orig_gen = backend.gen_duration
    orig_search = backend.search_charged
    orig_stage = backend.stage_charged

    if mode == "record":
        def gen_duration(n_prefill_tokens, batch, n_steps):
            charge = orig_gen(n_prefill_tokens, batch, n_steps)
            tape.record("gen", charge)
            return charge

        def search_charged(work, worker_id=0):
            charge, fn = orig_search(work, worker_id)
            tape.record("search", charge)
            return charge, fn

        def stage_charged(task, worker_id=0):
            charge, fn = orig_stage(task, worker_id)
            tape.record("stage", charge)
            return charge, fn
    else:
        def _rebook(worker_id, measured, taped):
            busy = getattr(backend, "worker_busy_us", None)
            if busy is not None:
                busy[worker_id] = (busy.get(worker_id, 0.0)
                                   - measured + taped)

        def gen_duration(n_prefill_tokens, batch, n_steps):
            orig_gen(n_prefill_tokens, batch, n_steps)
            return tape.next("gen")

        def search_charged(work, worker_id=0):
            measured, fn = orig_search(work, worker_id)
            taped = tape.next("search")
            _rebook(worker_id, measured, taped)
            return taped, fn

        def stage_charged(task, worker_id=0):
            measured, fn = orig_stage(task, worker_id)
            taped = tape.next("stage")
            _rebook(worker_id, measured, taped)
            return taped, fn

    backend.gen_duration = gen_duration
    backend.search_charged = search_charged
    backend.stage_charged = stage_charged
    return backend


@dataclasses.dataclass
class _Parked:
    """A shed request waiting for the admission backlog to drop."""
    seq: int
    req: object
    ticket: Optional[Ticket]
    attempts: int = 0
    next_try_us: float = 0.0


@owned_by("server")
class ServingLoop:
    """Scheduler-thread driver of a wall-clock run.

    Owns the ingress queue, the recorded trace, the ticket table, and the
    shed-request parking lot.  All scheduler state is touched from the
    thread calling :meth:`pump` — producer threads only ever touch the
    queue (``put``) and their own tickets (``wait``), which is exactly the
    single-writer discipline the ``ownership/*`` lint rules enforce.

    Every virtual-clock advance goes through a recorded row: arrivals and
    heartbeats carry producer stamps, and idle ticks (no queued rows, wall
    time moved on) are recorded too — so the replay visits the identical
    sequence of event-clock instants and the per-request event fingerprints
    match bit-for-bit.
    """

    def __init__(self, server, *, clock: Optional[WallClock] = None,
                 trace: Optional[ArrivalTrace] = None,
                 queue_maxsize: int = 4096,
                 tick_interval_us: float = 50_000.0,
                 readmit: bool = True,
                 readmit_backlog_us: float = float("inf"),
                 readmit_retry_us: float = 100_000.0,
                 max_readmit_attempts: int = 8,
                 poll_interval_s: float = 0.0005):
        self.server = server
        self.clock = clock if clock is not None else WallClock()
        self.queue = IngressQueue(maxsize=queue_maxsize)
        self.trace = trace if trace is not None else ArrivalTrace()
        self.tick_interval_us = float(tick_interval_us)
        self.readmit_enabled = bool(readmit)
        self.readmit_backlog_us = float(readmit_backlog_us)
        self.readmit_retry_us = float(readmit_retry_us)
        self.max_readmit_attempts = max(1, int(max_readmit_attempts))
        self.poll_interval_s = float(poll_interval_s)
        self._tickets: dict[int, Ticket] = {}  # request_id -> ticket
        self._parked: list[_Parked] = []
        self._done_idx = 0
        self._next_wall_sample_us = 0.0

    # ------------------------------------------------------------ plumbing
    def submit(self, workflow: str, text: str = "",
               ticket: Optional[Ticket] = None) -> Optional[int]:
        """Producer-side convenience: stamp now and enqueue an arrival.
        Safe from any thread; returns the queue submission seq."""
        return self.queue.put(ARRIVAL, self.clock.now_us(),
                              workflow=workflow, text=text, ticket=ticket)

    def unsettled(self) -> int:
        """Ticketed requests not yet resolved (admitted-in-flight or parked
        awaiting re-admission)."""
        return (len(self._tickets)
                + sum(1 for p in self._parked if p.ticket is not None))

    def _advance(self, t_us: float) -> float:
        """Step the event clock to the effective instant for a stamp."""
        eff = max(float(t_us), self.server.sched.now)
        self.server.step(eff)
        return eff

    def _note_row(self, kind: str) -> None:
        tel = self.server.sched.telemetry
        if tel is not None:
            tel.on_ingress_row(kind)

    # ------------------------------------------------------------ applying
    def _apply_arrival(self, it: IngressItem) -> None:
        eff = self._advance(it.t_us)
        req = self.server.build_request(it.text, it.workflow, eff)
        rid = self.server.submit_built(req)
        self.trace.record(TraceRow(
            seq=it.seq, t_us=eff, kind=ARRIVAL, workflow=it.workflow,
            text=it.text, admitted=rid is not None,
            request_id=-1 if rid is None else rid))
        self._note_row(ARRIVAL)
        if rid is not None:
            if it.ticket is not None:
                self._tickets[rid] = it.ticket
        elif self.readmit_enabled:
            self._parked.append(_Parked(
                seq=it.seq, req=req, ticket=it.ticket,
                next_try_us=self.server.sched.now + self.readmit_retry_us))
        elif it.ticket is not None:
            it.ticket.resolve("shed")

    def _apply_heartbeat(self, it: IngressItem) -> None:
        eff = self._advance(it.t_us)
        self.server.heartbeat_worker(it.wid, eff)
        self.trace.record(TraceRow(seq=it.seq, t_us=eff, kind=HEARTBEAT,
                                   wid=it.wid))
        self._note_row(HEARTBEAT)

    def _maybe_tick(self) -> None:
        """Idle advance: no queued rows but wall time moved on — record the
        advance so the replay visits the same instant."""
        wall = self.clock.now_us()
        if wall >= self.server.sched.now + self.tick_interval_us:
            eff = self._advance(wall)
            self.trace.record(TraceRow(seq=-1, t_us=eff, kind=TICK))
            self._note_row(TICK)

    def _post_completions(self) -> None:
        done = self.server.sched.done
        while self._done_idx < len(done):
            r = done[self._done_idx]
            self._done_idx += 1
            t = self._tickets.pop(r.request_id, None)
            if t is not None:
                t.resolve("finished", request_id=r.request_id,
                          finish_us=r.finish_us,
                          latency_us=float(r.finish_us) - float(r.arrival_us))

    def _maybe_readmit(self) -> None:
        if not self._parked:
            return
        load = self.server.admission_load()
        has_room = (load["max_pending"] <= 0
                    or load["in_system"] < load["max_pending"])
        if not has_room or load["backlog_us"] > self.readmit_backlog_us:
            return
        now = self.server.sched.now
        still: list[_Parked] = []
        for p in self._parked:
            if now < p.next_try_us:
                still.append(p)
                continue
            rid = self.server.readmit_request(p.req)
            self.trace.record(TraceRow(
                seq=-1, t_us=self.server.sched.now, kind=READMIT, ref=p.seq,
                admitted=rid is not None,
                request_id=-1 if rid is None else rid))
            self._note_row(READMIT)
            if rid is not None:
                if p.ticket is not None:
                    self._tickets[rid] = p.ticket
                continue
            p.attempts += 1
            if p.attempts >= self.max_readmit_attempts:
                if p.ticket is not None:
                    p.ticket.resolve("shed")
                continue  # final shed: stays counted in shed_final
            p.next_try_us = now + self.readmit_retry_us * (p.attempts + 1)
            still.append(p)
        self._parked = still

    def _sample_wall(self) -> None:
        """Passive obs tap: hand wall/virtual clock values to the telemetry
        sampler (obs never reads the wall clock itself).  Unrecorded — it
        changes no scheduling decision, so replay identity is unaffected."""
        tel = self.server.sched.telemetry
        if tel is None:
            return
        wall = self.clock.now_us()
        if wall < self._next_wall_sample_us:
            return
        self._next_wall_sample_us = wall + self.tick_interval_us
        tel.on_wall_sample(wall_us=wall, virtual_us=self.server.sched.now,
                           queue_depth=self.queue.pending_count(),
                           parked=len(self._parked))

    # ---------------------------------------------------------------- pump
    def pump(self, done: Callable[[], bool],
             max_wall_s: float = 120.0) -> None:
        """Drain/apply until ``done()`` holds with the queue empty and no
        work or unsettled tickets outstanding.  Runs on the scheduler
        thread; raises ``TimeoutError`` after ``max_wall_s`` of wall time
        (a liveness bar, not a correctness knob)."""
        deadline = time.monotonic() + float(max_wall_s)
        while True:
            items = self.queue.drain()
            for it in items:
                if it.kind == ARRIVAL:
                    self._apply_arrival(it)
                elif it.kind == HEARTBEAT:
                    self._apply_heartbeat(it)
                else:
                    raise ValueError(f"unexpected ingress row {it.kind!r}")
            self._post_completions()
            self._maybe_readmit()
            self._sample_wall()
            if not items:
                self._maybe_tick()
                self._post_completions()
                self._maybe_readmit()
                sched = self.server.sched
                if (done() and self.queue.pending_count() == 0
                        and self.unsettled() == 0 and not self._parked
                        and not sched.active and not sched.pending):
                    return
                time.sleep(self.poll_interval_s)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"wall-clock serve exceeded max_wall_s={max_wall_s}")


# ---------------------------------------------------------------------------
# Heartbeat pump (producer thread)
# ---------------------------------------------------------------------------


def _pump_heartbeats(loop: ServingLoop, stop: threading.Event,
                     interval_s: float) -> None:
    """Producer thread: enqueue wall-stamped heartbeats for every worker.
    With a FaultPlan armed the pump mirrors the plan (a crashed or stalled
    worker stops heartbeating), so chaos runs behave — and replay — exactly
    like the plan-driven virtual model."""
    server = loop.server
    plan = getattr(server.backend, "fault_plan", None)
    while not stop.is_set():
        t = loop.clock.now_us()
        for wid in range(server.sched.num_ret_workers):
            if plan is not None:
                c = plan.crash_at(wid)
                if c is not None and t >= c:
                    continue
                if plan.heartbeat_pause_start(wid, t) is not None:
                    continue
            loop.queue.put(HEARTBEAT, t, wid=wid)
        stop.wait(interval_s)


def _start_heartbeats(loop: ServingLoop, heartbeats: Optional[bool],
                      speedup: float):
    """Start the pump when asked (or by default when the registry actually
    watches heartbeat gaps).  Returns (thread, stop_event) or (None, None)."""
    server = loop.server
    if heartbeats is None:
        heartbeats = (server.config.external_heartbeats
                      or getattr(server.backend, "fault_plan", None)
                      is not None)
    if not heartbeats:
        return None, None
    interval_s = server.config.heartbeat_interval_us / (1e6 * speedup)
    stop = threading.Event()
    th = threading.Thread(target=_pump_heartbeats,
                          args=(loop, stop, interval_s), daemon=True)
    th.start()
    return th, stop


# ---------------------------------------------------------------------------
# Front-ends: open-loop replayer / closed-loop clients
# ---------------------------------------------------------------------------


def serve_wallclock(server, stream: Iterable, *, speedup: float = 1.0,
                    heartbeats: Optional[bool] = None,
                    max_wall_s: float = 120.0,
                    loop: Optional[ServingLoop] = None, **loop_kw):
    """Open-loop wall-clock serve: a producer thread replays ``stream``
    (StreamItem-likes or ``(arrival_us, text, workflow)`` tuples) in wall
    time — arrival stamps are *real* clock readings, not the stream's
    virtual stamps — while the calling thread pumps the scheduler.
    Returns ``(Metrics, ArrivalTrace)``."""
    loop = loop if loop is not None else ServingLoop(
        server, clock=WallClock(speedup=speedup), **loop_kw)
    items = list(stream)
    producers_done = threading.Event()

    def produce() -> None:
        try:
            for it in items:
                if hasattr(it, "arrival_us"):
                    target, text, wf = (float(it.arrival_us), it.text,
                                        it.workflow)
                else:
                    target, text, wf = (float(it[0]), it[1], it[2])
                while True:
                    now = loop.clock.now_us()
                    if now >= target:
                        break
                    time.sleep(min((target - now) / (1e6 * speedup), 0.05))
                loop.queue.put(ARRIVAL, loop.clock.now_us(),
                               workflow=wf, text=text)
        finally:
            producers_done.set()

    producer = threading.Thread(target=produce, daemon=True)
    hb_thread, hb_stop = _start_heartbeats(loop, heartbeats, speedup)
    producer.start()
    try:
        loop.pump(done=producers_done.is_set, max_wall_s=max_wall_s)
    finally:
        if hb_stop is not None:
            hb_stop.set()
        loop.queue.close()
        producer.join(timeout=5.0)
        if hb_thread is not None:
            hb_thread.join(timeout=5.0)
    metrics = server.run()
    loop._post_completions()
    return metrics, loop.trace


def closed_loop_serve(server, spec, *, speedup: float = 1.0,
                      heartbeats: Optional[bool] = None,
                      max_wall_s: float = 120.0,
                      loop: Optional[ServingLoop] = None, **loop_kw):
    """Closed-loop wall-clock serve: ``spec.num_clients`` client threads
    each submit, block on their ticket, think, and repeat, under the
    spec's shared token budget (``serving.workload.ClosedLoopSpec``).
    Returns ``(Metrics, ArrivalTrace)``."""
    loop = loop if loop is not None else ServingLoop(
        server, clock=WallClock(speedup=speedup), **loop_kw)
    budget = _TokenBudget(spec.token_budget)

    def client(cid: int) -> None:
        for draw in spec.plan(cid):
            if not budget.take(draw.est_tokens):
                break
            ticket = Ticket()
            seq = loop.queue.put(ARRIVAL, loop.clock.now_us(),
                                 workflow=draw.workflow, text=draw.text,
                                 ticket=ticket)
            if seq is None:
                break
            if not ticket.wait(timeout_s=max_wall_s):
                break
            time.sleep(draw.think_s / speedup)

    clients = [threading.Thread(target=client, args=(cid,), daemon=True)
               for cid in range(spec.num_clients)]
    hb_thread, hb_stop = _start_heartbeats(loop, heartbeats, speedup)
    for th in clients:
        th.start()
    try:
        loop.pump(done=lambda: all(not th.is_alive() for th in clients),
                  max_wall_s=max_wall_s)
    finally:
        if hb_stop is not None:
            hb_stop.set()
        loop.queue.close()
        for th in clients:
            th.join(timeout=5.0)
        if hb_thread is not None:
            hb_thread.join(timeout=5.0)
    metrics = server.run()
    loop._post_completions()
    return metrics, loop.trace


class _TokenBudget:
    """Thread-safe shared token budget for closed-loop load generation
    (0 = unlimited)."""

    def __init__(self, budget: int):
        self._lock = threading.Lock()
        self.budget = int(budget)
        self.spent = 0

    def take(self, n: int) -> bool:
        with self._lock:
            if self.budget > 0 and self.spent + int(n) > self.budget:
                return False
            self.spent += int(n)
            return True


# ---------------------------------------------------------------------------
# The oracle: deterministic replay on the virtual clock
# ---------------------------------------------------------------------------


def replay_trace(server, trace: ArrivalTrace, max_time_us: float = 4e9):
    """Re-apply a recorded wall-clock run on a *fresh* server over the pure
    virtual clock: step to each row's effective instant, re-issue the same
    submissions/heartbeats/re-admissions in the same order, then drain.

    The admission outcome of every arrival/readmit row is recomputed live
    and checked against the recording — a mismatch raises
    :class:`ReplayDivergence` (it would mean scheduler state diverged).
    Returns the drained ``Metrics``; compare ``server.fingerprints()``
    against the recorded run's for the bit-identity check."""
    parked: dict[int, object] = {}
    for row in trace.rows:
        eff = max(float(row.t_us), server.sched.now)
        server.step(eff)
        if row.kind == ARRIVAL:
            req = server.build_request(row.text, row.workflow, eff)
            rid = server.submit_built(req)
            _expect(row, rid)
            if rid is None:
                parked[row.seq] = req
        elif row.kind == READMIT:
            req = parked.get(row.ref)
            if req is None:
                raise ReplayDivergence(
                    f"readmit row references unknown shed arrival seq "
                    f"{row.ref}")
            rid = server.readmit_request(req)
            _expect(row, rid)
            if rid is not None:
                del parked[row.ref]
        elif row.kind == HEARTBEAT:
            server.heartbeat_worker(row.wid, eff)
        elif row.kind != TICK:
            raise ReplayDivergence(f"unknown trace row kind {row.kind!r}")
    return server.run(max_time_us=max_time_us)


def _expect(row: TraceRow, rid: Optional[int]) -> None:
    admitted = rid is not None
    if admitted != row.admitted:
        raise ReplayDivergence(
            f"{row.kind} row seq={row.seq} t={row.t_us}: recorded "
            f"admitted={row.admitted}, replay got {admitted}")
    if admitted and row.request_id >= 0 and rid != row.request_id:
        raise ReplayDivergence(
            f"{row.kind} row seq={row.seq}: recorded request_id="
            f"{row.request_id}, replay assigned {rid}")

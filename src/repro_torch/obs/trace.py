"""Span tracing for the wavefront serving loop.

The :class:`TraceRecorder` is a *passive* observer the scheduler feeds when
``SchedulerConfig.tracing`` is on: every dispatched job (generation batch,
retrieval plan, host stage batch), every shard scatter/gather, hedge twin,
fusion fan-out, retry, failover, and lifecycle transition is recorded as a
span or instant on a per-resource track — the virtual clock supplies the
timestamps, so the trace reconstructs exactly the timeline the scheduler
executed.  Recording never draws randomness, never mutates scheduler state,
and never touches per-request event logs; enabling it leaves serving
bit-identical.

``to_chrome()`` renders the record as Chrome trace-event JSON (the
``traceEvents`` array format), which both ``chrome://tracing`` and Perfetto
open directly:

* one *track* (pid/tid pair) per resource — the admission queue /
  scheduler, the generation engine, and each retrieval worker;
* ``X`` (complete) events for work spans, ``i`` instants for arrivals,
  merges, fusions, failovers, and lifecycle transitions;
* ``s``/``f`` flow events linking a request's consecutive sub-stages,
  scatter parts to their gather merge, original jobs to their hedge twins,
  dedup leaders to fanned-out followers, and lost work to its failover
  re-dispatch.

The same record doubles as the input to ``obs.attribution``: every span
contributes a categorized per-request interval (generation / retrieval /
stage compute, merge, retry and fault-recovery wait gaps).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.core.ownership import handoff, owned_by

# track keys ---------------------------------------------------------------
QUEUE_TRACK = ("queue",)
GEN_TRACK = ("gen",)


def ret_track(wid: int) -> tuple:
    return ("ret", int(wid))


def _tid(track: tuple) -> int:
    if track == QUEUE_TRACK:
        return 0
    if track == GEN_TRACK:
        return 1
    return 10 + int(track[1])


def _track_name(track: tuple) -> str:
    if track == QUEUE_TRACK:
        return "admission queue / scheduler"
    if track == GEN_TRACK:
        return "gen engine"
    return f"retrieval worker {track[1]}"


_PID = 1  # single virtual process: the server


@dataclasses.dataclass
class _ReqTrace:
    """Per-request bookkeeping: the attribution intervals plus the frontier
    state that turns consecutive spans into dependency flow edges."""

    rid: int
    arrival_us: float
    workflow: str
    slo_us: float
    finish_us: Optional[float] = None
    degraded: bool = False
    # [start_us, end_us, component] — mutable so a lost job's compute can be
    # reclassified as fault recovery after the fact
    intervals: list = dataclasses.field(default_factory=list)
    # (track, ts) flow-edge source for the next dispatched span; spans
    # overlapping the current frontier (parallel scatter parts, hedge twins)
    # fan out from the same source instead of chaining serially
    fan_src: Optional[tuple] = None
    frontier: Optional[tuple] = None  # (track, end_us) of furthest span
    gap: Optional[tuple] = None  # (start_us, component) open wait gap


@owned_by("obs")
class TraceRecorder:
    def __init__(self):
        self.spans: list[dict] = []
        self.instants: list[dict] = []
        self.flows: list[dict] = []
        self.requests: dict[int, _ReqTrace] = {}
        self._gather_parts: dict[int, list] = {}  # id(gather) -> flow points
        # id(job) -> (span, attribution rows): recorder-owned side tables —
        # stashing these on the scheduler's job dicts would make the
        # recorder a writer of scheduler state (hooks/obs-mutation)
        self._job_spans: dict[int, dict] = {}
        self._job_rows: dict[int, list] = {}
        self._next_flow = 0

    # ------------------------------------------------------------ low level
    def _req(self, req) -> _ReqTrace:
        e = self.requests.get(req.request_id)
        if e is None:
            e = _ReqTrace(rid=req.request_id,
                          arrival_us=float(req.arrival_us),
                          workflow=req.graph.name,
                          slo_us=float(req.slo_us or 0.0))
            e.fan_src = (QUEUE_TRACK, e.arrival_us)
            self.requests[req.request_id] = e
        return e

    def _span(self, track: tuple, name: str, ts: float, dur: float,
              cat: str, args: dict) -> dict:
        s = {"track": track, "name": name, "ts": float(ts),
             "dur": float(dur), "cat": cat, "args": args}
        self.spans.append(s)
        return s

    def _instant(self, track: tuple, name: str, ts: float, cat: str,
                 args: Optional[dict] = None) -> dict:
        i = {"track": track, "name": name, "ts": float(ts), "cat": cat,
             "args": args or {}}
        self.instants.append(i)
        return i

    def _flow(self, cat: str, src: tuple, dst: tuple,
              name: str = "") -> None:
        self.flows.append({"fid": self._next_flow, "cat": cat,
                           "name": name or cat,
                           "src": (src[0], float(src[1])),
                           "dst": (dst[0], float(dst[1]))})
        self._next_flow += 1

    def _attach(self, req, track: tuple, ts: float, end: float,
                component: str) -> list:
        """Register a work span's interval for ``req`` and emit the
        dependency flow edge from the request's frontier.  Returns the
        (mutable) interval row so a lost job can reclassify it later."""
        e = self._req(req)
        flow_cat = "dep"
        if e.gap is not None:
            g0, gcomp = e.gap
            if ts > g0:
                e.intervals.append([g0, float(ts), gcomp])
            e.gap = None
            flow_cat = ("failover" if gcomp == "fault_recovery"
                        else "retry")
        if e.frontier is not None and ts >= e.frontier[1] - 1e-9:
            # strictly after all prior work: a new hop in the chain
            e.fan_src = e.frontier
        if e.fan_src is not None:
            self._flow(flow_cat, e.fan_src, (track, ts),
                       name=f"r{e.rid}")
        if e.frontier is None or end > e.frontier[1]:
            e.frontier = (track, end)
        row = [float(ts), float(end), component]
        e.intervals.append(row)
        return row

    # ----------------------------------------------------- scheduler hooks
    @handoff("scheduler")
    def request_submitted(self, req, now: float) -> None:
        e = self._req(req)
        self._instant(QUEUE_TRACK, f"arrive r{e.rid}", e.arrival_us,
                      "request", {"request": e.rid, "workflow": e.workflow,
                                  "slo_us": e.slo_us})

    @handoff("scheduler")
    def request_shed(self, req, now: float, reason: str) -> None:
        self._instant(QUEUE_TRACK, f"shed r{req.request_id}",
                      float(max(now, req.arrival_us)), "shed",
                      {"request": req.request_id, "reason": reason,
                       "workflow": req.graph.name})

    @handoff("scheduler")
    def request_finished(self, req, now: float) -> None:
        e = self._req(req)
        if e.gap is not None:
            g0, gcomp = e.gap
            if now > g0:
                e.intervals.append([g0, float(now), gcomp])
            e.gap = None
        e.finish_us = float(now)
        e.degraded = bool(req.state.get("_degraded"))
        self._instant(QUEUE_TRACK, f"finish r{e.rid}", now, "request",
                      {"request": e.rid, "workflow": e.workflow,
                       "latency_us": float(now) - e.arrival_us,
                       "degraded": e.degraded})

    @handoff("scheduler")
    def gen_job(self, job, now: float) -> None:
        reqs = job["reqs"]
        rids = [r.request_id for r in reqs]
        span = self._span(
            GEN_TRACK, f"gen b{len(reqs)} s{job['n_steps']}", now,
            job["end"] - now, "gen",
            {"requests": rids, "n_steps": int(job["n_steps"])})
        self._job_spans[id(job)] = span
        rows = []
        for r in reqs:
            rows.append(self._attach(r, GEN_TRACK, now, job["end"],
                                     "generation_compute"))
        self._job_rows[id(job)] = rows

    @handoff("scheduler")
    def ret_job(self, job, wid: int, now: float, hedge: bool) -> None:
        track = ret_track(wid)
        end = float(job["end"])
        kinds: dict[str, int] = {}
        rids: list[int] = []
        rows = []
        plan = job["plan"]
        if plan is not None:
            for g, meta in enumerate(plan.group_meta):
                kind = meta[0]
                kinds[kind] = kinds.get(kind, 0) + 1
                if kind == "ret":
                    r = meta[1]
                    rids.append(r.request_id)
                    rows.append(self._attach(r, track, now, end,
                                             "retrieval_compute"))
                elif kind == "shard":
                    gather = meta[1]
                    r = gather.req
                    rids.append(r.request_id)
                    rows.append(self._attach(r, track, now, end,
                                             "retrieval_compute"))
                    self._gather_parts.setdefault(id(gather), []).append(
                        (track, end))
                elif kind == "stage":
                    r = meta[1]
                    rids.append(r.request_id)
                    rows.append(self._attach(r, track, now, end,
                                             "stage_compute"))
                # "spec" warmups are background work: on the span, not
                # attributable to any request's latency
        for task, _fn in job.get("tasks", ()):
            kinds[task.kind] = kinds.get(task.kind, 0) + 1
            rids.append(task.req.request_id)
            rows.append(self._attach(task.req, track, now, end,
                                     "stage_compute"))
        name = "+".join(f"{k}x{n}" for k, n in sorted(kinds.items())) or "ret"
        if hedge:
            name = f"hedge {name}"
        span = self._span(track, name, now, end - now,
                          "hedge" if hedge else "ret",
                          {"requests": sorted(set(rids)), "worker": int(wid),
                           "hedge": bool(hedge)})
        self._job_spans[id(job)] = span
        self._job_rows[id(job)] = rows

    @handoff("scheduler")
    def ret_job_lost(self, job, now: float) -> None:
        """The worker died mid-job: its results are fenced, so the time the
        involved requests spent on it was recovery, not service."""
        span = self._job_spans.get(id(job))
        if span is not None:
            span["args"] = dict(span["args"], lost=True)
            span["name"] = f"lost {span['name']}"
            span["cat"] = "lost"
        for row in self._job_rows.get(id(job), ()):
            row[2] = "fault_recovery"

    @handoff("scheduler")
    def hedge_link(self, job, hjob, now: float) -> None:
        src = self._job_spans.get(id(job))
        dst = self._job_spans.get(id(hjob))
        if src is None or dst is None:
            return
        self._flow("hedge", (src["track"], dst["ts"]),
                   (dst["track"], dst["ts"]), name="hedge")

    @handoff("scheduler")
    def gather_merge(self, gather, now: float) -> None:
        rid = gather.req.request_id
        parts = self._gather_parts.pop(id(gather), [])
        self._instant(QUEUE_TRACK, f"merge r{rid}", now, "gather",
                      {"request": rid, "parts": len(parts),
                       "clusters": len(gather.clusters)})
        for p in parts:
            self._flow("gather", p, (QUEUE_TRACK, now), name=f"r{rid}")
        e = self.requests.get(rid)
        if e is not None:
            e.intervals.append([float(now), float(now), "merge"])

    @handoff("scheduler")
    def fanout(self, leader, sub, now: float, kind: str) -> None:
        e = self._req(leader)
        src = e.frontier or (QUEUE_TRACK, float(now))
        self._instant(QUEUE_TRACK, f"fused r{sub.request_id}", now,
                      "fusion", {"request": sub.request_id,
                                 "leader": leader.request_id, "kind": kind})
        self._flow("fusion", src, (QUEUE_TRACK, float(now)),
                   name=f"r{leader.request_id}->r{sub.request_id}")

    @handoff("scheduler")
    def open_gap(self, req, now: float, component: str) -> None:
        """Start a wait gap (``retry_hedge_failover`` backoff or
        ``fault_recovery`` after a worker death); closed by the request's
        next dispatched span, or at finish."""
        if req is None or req.finished:
            return
        e = self._req(req)
        if e.gap is None:
            e.gap = (float(now), component)

    @handoff("scheduler")
    def failover(self, req, wid: int, now: float) -> None:
        self._instant(QUEUE_TRACK, f"failover r{req.request_id}->w{wid}",
                      now, "failover",
                      {"request": req.request_id, "worker": int(wid)})

    @handoff("scheduler")
    def degraded(self, req, now: float) -> None:
        self._instant(QUEUE_TRACK, f"degraded r{req.request_id}", now,
                      "degraded", {"request": req.request_id})

    @handoff("scheduler")
    def worker_transition(self, wid: int, old: str, new: str,
                          now: float) -> None:
        self._instant(ret_track(wid), f"w{wid} {old}->{new}", now,
                      "lifecycle", {"worker": int(wid), "from": old,
                                    "to": new})

    # -------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Render as Chrome trace-event JSON (Perfetto-compatible)."""
        tracks = {QUEUE_TRACK, GEN_TRACK}
        for s in self.spans:
            tracks.add(s["track"])
        for i in self.instants:
            tracks.add(i["track"])
        for f in self.flows:
            tracks.add(f["src"][0])
            tracks.add(f["dst"][0])
        ev: list[dict] = [{
            "ph": "M", "pid": _PID, "tid": 0, "ts": 0.0,
            "name": "process_name", "args": {"name": "hedrarag-server"},
        }]
        for t in sorted(tracks, key=_tid):
            ev.append({"ph": "M", "pid": _PID, "tid": _tid(t), "ts": 0.0,
                       "name": "thread_name",
                       "args": {"name": _track_name(t)}})
        body: list[dict] = []
        for s in self.spans:
            body.append({"ph": "X", "pid": _PID, "tid": _tid(s["track"]),
                         "ts": s["ts"], "dur": max(s["dur"], 0.0),
                         "name": s["name"], "cat": s["cat"],
                         "args": s["args"]})
        for i in self.instants:
            body.append({"ph": "i", "s": "t", "pid": _PID,
                         "tid": _tid(i["track"]), "ts": i["ts"],
                         "name": i["name"], "cat": i["cat"],
                         "args": i["args"]})
        for f in self.flows:
            base = {"name": f["name"], "cat": f["cat"], "id": f["fid"],
                    "pid": _PID}
            body.append(dict(base, ph="s", tid=_tid(f["src"][0]),
                             ts=f["src"][1]))
            body.append(dict(base, ph="f", bp="e", tid=_tid(f["dst"][0]),
                             ts=f["dst"][1]))
        # stable global time sort keeps every per-track ts sequence monotone
        body.sort(key=lambda e: e["ts"])
        return {
            "traceEvents": ev + body,
            "displayTimeUnit": "ms",
            "otherData": {
                "generator": "repro_torch.obs.trace",
                "n_requests": len(self.requests),
                "clock": "virtual-us",
            },
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)


# ---------------------------------------------------------------------------
# Structural validation (used by tests, the CLI, and CI)
# ---------------------------------------------------------------------------

_ALLOWED_PH = {"M", "X", "i", "B", "E", "s", "f", "t"}


def validate_trace(trace: dict) -> list[str]:
    """Structural validity of a Chrome trace-event JSON object.  Returns a
    list of human-readable problems — empty means valid:

    * top-level ``traceEvents`` list, every event carrying ``ph`` / ``pid``
      / ``tid`` / ``ts`` / ``name``;
    * only known phase codes, ``X`` events with non-negative ``dur``;
    * per-(pid, tid) timestamps non-decreasing in array order;
    * ``B``/``E`` duration events balanced per track;
    * every flow id has both a start (``s``) and a finish (``f``) event.
    """
    problems: list[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    last_ts: dict[tuple, float] = {}
    be_stack: dict[tuple, int] = {}
    flow_s: dict = {}
    flow_f: dict = {}
    for n, e in enumerate(evs):
        for key in ("ph", "pid", "tid", "ts", "name"):
            if key not in e:
                problems.append(f"event {n}: missing {key!r}")
        ph = e.get("ph")
        if ph not in _ALLOWED_PH:
            problems.append(f"event {n}: unknown phase {ph!r}")
            continue
        track = (e.get("pid"), e.get("tid"))
        ts = float(e.get("ts", 0.0))
        if ph != "M":
            if ts < last_ts.get(track, float("-inf")):
                problems.append(
                    f"event {n}: ts {ts} decreases on track {track}")
            last_ts[track] = ts
        if ph == "X" and float(e.get("dur", -1.0)) < 0.0:
            problems.append(f"event {n}: X event with negative/missing dur")
        elif ph == "B":
            be_stack[track] = be_stack.get(track, 0) + 1
        elif ph == "E":
            be_stack[track] = be_stack.get(track, 0) - 1
            if be_stack[track] < 0:
                problems.append(f"event {n}: E without matching B on {track}")
        elif ph == "s":
            flow_s.setdefault(e.get("id"), 0)
            flow_s[e.get("id")] += 1
        elif ph in ("f", "t"):
            flow_f.setdefault(e.get("id"), 0)
            flow_f[e.get("id")] += 1
    for track, depth in sorted(be_stack.items()):
        if depth != 0:
            problems.append(f"unbalanced B/E on track {track}: depth {depth}")
    for fid in sorted(set(flow_s) - set(flow_f), key=repr):
        problems.append(f"flow id {fid!r} has a start but no finish")
    for fid in sorted(set(flow_f) - set(flow_s), key=repr):
        problems.append(f"flow id {fid!r} has a finish but no start")
    return problems


def request_ids_in_trace(trace: dict) -> set:
    """Every request id referenced by any event's args (``request`` scalar
    or ``requests`` list) — the join key against the request journal."""
    out: set = set()
    for e in trace.get("traceEvents", ()):
        args = e.get("args") or {}
        if "request" in args:
            out.add(int(args["request"]))
        for rid in args.get("requests", ()):
            out.add(int(rid))
    return out

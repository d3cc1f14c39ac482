"""HedraRAG Server façade (paper Listing 1):

    from repro_torch.server import Server
    s = Server(index=..., embedder=..., mode="hedra")
    s.add_request("What is RAG?", g1)
    s.add_request("Compare RAG with long-context models.", g2)
    metrics = s.run()

The server owns admission (arrival times / Poisson open-loop), request-state
journaling (fault tolerance: completed requests are replayable), and the
wavefront scheduler + backend pair.

Streaming front-end (the paper's heterogeneous open-loop scenario): requests
can be submitted *mid-run* and the event clock advanced incrementally::

    s = Server(index, embedder, mode="hedra",
               max_pending=64,           # bounded arrival queue
               admission_control=True)   # deadline-infeasibility shedding
    for item in mix.sample(n=500, rate_per_s=12.0):   # serving/workload.py
        s.step(item.arrival_us)                        # advance the clock
        s.submit(item.text, item.workflow, arrival_us=item.arrival_us)
    metrics = s.run()                                  # drain
    metrics.window_summary(warmup_us, end_us)          # steady-state goodput

or equivalently in one call: ``metrics = s.serve(mix.sample(500, 12.0))``.
With no mid-run submissions and admission control disabled, the pre-loaded
batch path is bit-identical (per-request event fingerprints) to the legacy
run-to-completion loop.

Cross-request coordination (``repro_torch.crossreq``) is enabled through the same
keyword overrides as every other scheduler knob::

    s = Server(index, embedder, mode="hedra",
               global_cache_size=256,   # shared semantic cache entries
               dedup_threshold=0.95,    # in-flight query fusion (cosine)
               replication_factor=2)    # hot-cluster replicas across workers
    ...
    s.run(); s.crossreq_report()
"""
from __future__ import annotations

import glob
import json
import os
from typing import Iterable, Optional, Union

from repro_torch.core.backends import SimBackend
from repro_torch.core.ownership import owned_by
from repro_torch.core.ragraph import RAGraph
from repro_torch.core.runtime import RequestContext
from repro_torch.core.wavefront import Metrics, SchedulerConfig, WavefrontScheduler
from repro_torch.serving.workload import WorkloadProfile


def _json_safe(payload):
    """Journal event payloads must round-trip through JSON: native scalars
    pass through, numpy scalars unwrap, anything structured stringifies."""
    if payload is None or isinstance(payload, (bool, int, float, str)):
        return payload
    if hasattr(payload, "item") and getattr(payload, "ndim", None) == 0:
        return _json_safe(payload.item())
    return repr(payload)


@owned_by("server")
class Server:
    def __init__(
        self,
        index,
        embedder,
        *,
        mode: str = "hedra",
        backend=None,
        config: Optional[SchedulerConfig] = None,
        workload: Optional[WorkloadProfile] = None,
        journal_path: Optional[str] = None,
        fault_plan=None,
        **cfg_overrides,
    ):
        self.index = index
        self.embedder = embedder
        self.config = config or SchedulerConfig.preset(mode, **cfg_overrides)
        self.backend = backend or SimBackend(index, embedder)
        if fault_plan is not None:
            # injected faults ride on the backend's timing hooks; the
            # scheduler picks the plan up from there and arms recovery
            self.backend.fault_plan = fault_plan
        self.workload = workload or WorkloadProfile()
        self.sched = WavefrontScheduler(self.backend, index, self.config,
                                        self.workload)
        self.journal_path = journal_path
        self._next_id = 0
        # crash recovery is automatic on a journal-backed start: unfinished
        # rows in an existing journal re-enter the queue with their original
        # request ids and pre-crash event prefixes
        self.recovered_ids: list = []
        if journal_path:
            self._sweep_journal_tmp(journal_path)
            if os.path.exists(journal_path):
                self.recovered_ids = self.readmit(
                    self.replay_unfinished(journal_path))

    # ------------------------------------------------------------------ API
    def _alloc_id(self) -> int:
        rid = self._next_id
        self._next_id += 1
        return rid

    def _build_request(self, input_text: str, graph: RAGraph,
                       arrival_us: float,
                       request_id: Optional[int] = None) -> RequestContext:
        if request_id is None:
            rid = self._alloc_id()
        else:
            # journal recovery pins the original id; future native ids must
            # never collide with it
            rid = int(request_id)
            self._next_id = max(self._next_id, rid + 1)
        graph.validate()
        state = {"input": input_text,
                 "_target_rounds": self.workload.iterations(rid)}
        return RequestContext(request_id=rid, graph=graph, state=state,
                              arrival_us=float(arrival_us),
                              slo_us=self.workload.slo_us(rid, graph.name))

    def add_request(self, input_text: str, graph: RAGraph,
                    arrival_us: float = 0.0) -> Optional[int]:
        """Pre-load a request (batch path).  Returns its id, or ``None``
        when an enabled admission-control knob sheds it (check
        ``is not None`` — id 0 is a valid request)."""
        req = self._build_request(input_text, graph, arrival_us)
        if not self.sched.add_request(req):
            return None
        return req.request_id

    def submit(self, input_text: str, graph: Union[RAGraph, str],
               arrival_us: Optional[float] = None) -> Optional[int]:
        """Admit a request *mid-run* (streaming path).  ``graph`` may be a
        built RAGraph or a workflow name; ``arrival_us`` defaults to the
        current event clock and must not lie in its past — the virtual
        clock cannot honor a stale stamp, and silently rewriting it would
        corrupt latency/SLO accounting.  Returns the request id, or
        ``None`` when the admission layer sheds it (check ``is not None``
        — id 0 is a valid request; ``Metrics.shed_*`` has the reason)."""
        if isinstance(graph, str):
            from repro_torch import workflows

            graph = workflows.build(graph)
        now = self.sched.now
        arrival = now if arrival_us is None else float(arrival_us)
        if arrival < now:
            raise ValueError(
                f"arrival_us={arrival} is in the past (event clock at "
                f"{now}); submissions must be arrival-ordered")
        req = self._build_request(input_text, graph, arrival)
        if not self.sched.add_request(req):
            return None
        return req.request_id

    def build_request(self, input_text: str, graph: Union[RAGraph, str],
                      arrival_us: float) -> RequestContext:
        """Build (but do not submit) a request.  The ingress loop builds
        once and resubmits the *same* context across re-admission attempts,
        which preserves its id-keyed workload draws (iterations, SLO)."""
        if isinstance(graph, str):
            from repro_torch import workflows

            graph = workflows.build(graph)
        return self._build_request(input_text, graph, float(arrival_us))

    def submit_built(self, req: RequestContext) -> Optional[int]:
        """Submit a ``build_request`` context at its stamped arrival (same
        stale-arrival contract as ``submit``).  Returns the id, or ``None``
        when an admission knob sheds it."""
        if req.arrival_us < self.sched.now:
            raise ValueError(
                f"arrival_us={req.arrival_us} is in the past (event clock "
                f"at {self.sched.now}); submissions must be arrival-ordered")
        if not self.sched.add_request(req):
            return None
        return req.request_id

    def readmit_request(self, req: RequestContext,
                        arrival_us: Optional[float] = None) -> Optional[int]:
        """Re-admission attempt for a previously shed request (closed-loop
        ingress path): the request is re-stamped to the later of
        ``arrival_us`` and the event clock — its latency/SLO window restarts
        at re-admission — and re-offered.  Counted as a resubmission, never
        as a second shed/submit of the same logical request; the journal
        sees the context at most once because shed requests never enter
        done/active/pending.  Returns the id, or ``None`` while the
        admission layer still refuses it."""
        base = self.sched.now if arrival_us is None else float(arrival_us)
        req.arrival_us = max(base, self.sched.now)
        if not self.sched.add_request(req):
            return None
        return req.request_id

    def heartbeat_worker(self, wid: int, now_us: float) -> None:
        """Feed an external heartbeat for ``wid`` (wall-clock ingress path;
        see SchedulerConfig.external_heartbeats)."""
        self.sched.worker_heartbeat(wid, now_us)

    def admission_load(self) -> dict:
        """In-system population / queue bound / backlog estimate — the
        signal the ingress loop's re-admission gate polls."""
        return self.sched.admission_load()

    def step(self, until_us: float) -> Metrics:
        """Advance the serving clock to ``until_us`` (streaming)."""
        return self.sched.step(until_us)

    def fingerprints(self) -> dict:
        """Per-request event fingerprints of every finished request: the
        bit-identity contract between a wall-clock ingress run and its
        virtual-clock replay (and between streaming and batch paths)."""
        return {r.request_id: [(float(t), e, repr(p)) for t, e, p in r.events]
                for r in self.sched.done}

    def serve_wallclock(self, stream: Optional[Iterable] = None, *,
                        closed_loop=None, speedup: float = 1.0,
                        max_wall_s: float = 120.0, **kw):
        """Threaded wall-clock serve (serving/ingress.py): producer threads
        timestamp real arrivals into the ingress queue while this thread
        drains it into the scheduler.  Returns ``(Metrics, ArrivalTrace)``;
        the trace replays through ``serving.ingress.replay_trace`` to
        bit-identical per-request event fingerprints."""
        from repro_torch.serving import ingress

        if (stream is None) == (closed_loop is None):
            raise ValueError("pass exactly one of stream / closed_loop")
        if closed_loop is not None:
            return ingress.closed_loop_serve(
                self, closed_loop, speedup=speedup, max_wall_s=max_wall_s,
                **kw)
        return ingress.serve_wallclock(
            self, stream, speedup=speedup, max_wall_s=max_wall_s, **kw)

    def serve(self, stream: Iterable, max_time_us: float = 4e9) -> Metrics:
        """Open-loop streaming serve: walk an arrival-ordered ``stream`` of
        requests, stepping the event clock to each arrival before submitting
        it (so admission decisions see true in-flight load), then drain.

        Stream items are either ``serving.workload.StreamItem``-likes (with
        ``.arrival_us``/``.workflow``/``.text``) or ``(arrival_us, text,
        graph_or_workflow_name)`` tuples."""
        for item in stream:
            if hasattr(item, "arrival_us"):
                arrival, text, graph = (item.arrival_us, item.text,
                                        item.workflow)
            else:
                arrival, text, graph = item
            arrival = float(arrival)
            if arrival > max_time_us:
                break
            self.sched.step(min(arrival, max_time_us))
            self.submit(text, graph, arrival_us=arrival)
        return self.run(max_time_us=max_time_us)

    def run(self, max_time_us: float = 4e9) -> Metrics:
        m = self.sched.run(max_time_us=max_time_us)
        if self.journal_path:
            self.write_journal(self.journal_path)
        return m

    def crossreq_report(self) -> dict:
        """Cross-request coordination counters (empty when disabled)."""
        if self.sched.crossreq is None:
            return {}
        return self.sched.crossreq.report()

    # -------------------------------------------------------- observability
    def export_trace(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event / Perfetto JSON of the run so far (requires
        ``tracing=True``).  Returns the trace object; with ``path`` also
        writes it to disk (open in https://ui.perfetto.dev or
        ``chrome://tracing``)."""
        if self.sched.obs is None:
            raise RuntimeError(
                "tracing is off — construct the Server with tracing=True "
                "(SchedulerConfig.tracing) to record spans")
        trace = self.sched.obs.to_chrome()
        if path:
            with open(path, "w") as f:
                json.dump(trace, f, indent=1)
        return trace

    def metrics_snapshot(self, path: Optional[str] = None) -> dict:
        """Labeled-registry snapshot (requires ``telemetry=True``): the
        structured samples plus the Prometheus text exposition under
        ``"prometheus"`` and the virtual-clock sample timeline under
        ``"timeline"``.  With ``path`` also writes the JSON to disk."""
        tel = self.sched.telemetry
        if tel is None:
            raise RuntimeError(
                "telemetry is off — construct the Server with telemetry=True "
                "(SchedulerConfig.telemetry) to sample metrics")
        snap = tel.snapshot()
        snap["prometheus"] = tel.registry.render()
        if path:
            with open(path, "w") as f:
                json.dump(snap, f, indent=1)
        return snap

    def attribution_report(self, *, check: bool = True,
                           rel_tol: float = 1e-6) -> dict:
        """Per-request latency attribution + run-level bottleneck report
        (requires ``tracing=True``).  With ``check=True`` raises if any
        finished request's components fail to sum to its measured latency
        within ``rel_tol`` relative tolerance."""
        if self.sched.obs is None:
            raise RuntimeError(
                "tracing is off — construct the Server with tracing=True "
                "to enable latency attribution")
        from repro_torch.obs.attribution import attribution_report

        return attribution_report(self.sched.obs, check=check,
                                  rel_tol=rel_tol)

    # ------------------------------------------------------ worker lifecycle
    def register_worker(self) -> int:
        """Grow the pool mid-run: add a retrieval worker, returns its id."""
        return self.sched.register_worker()

    def drain_worker(self, wid: int) -> bool:
        """Stop scheduling new work on ``wid``; in-flight work finishes."""
        return self.sched.drain_worker(wid)

    def rebind_worker(self, wid: int) -> bool:
        """Bring a drained/dead worker back into the schedulable pool."""
        return self.sched.rebind_worker(wid)

    def lifecycle_report(self) -> dict:
        """Per-worker health states, heartbeats, and state-change timelines
        plus the pool-level recovery counters."""
        rep = self.sched.lifecycle.report()
        m = self.sched.metrics
        rep["counters"] = {
            "worker_suspects": m.worker_suspects,
            "worker_deaths": m.worker_deaths,
            "task_timeouts": m.task_timeouts,
            "redispatches": m.redispatches,
            "retries": m.retries,
            "transient_failures": m.transient_failures,
            "hedged_dispatches": m.hedged_dispatches,
            "hedged_wins": m.hedged_wins,
            "failovers": m.failovers,
            "degraded_drops": m.degraded_drops,
            "degraded_completions": m.degraded_completions,
        }
        return rep

    def shard_report(self) -> dict:
        """Shard-mode serving state (empty when ``index_sharding`` is off):
        the cluster-range ownership table, scatter/merge counters, and —
        when a hybrid engine is attached — per-worker device-slab
        residency."""
        sm = self.sched.shard_map
        if sm is None:
            return {}
        out = {
            "n_shards": sm.n_shards,
            "bounds": (sm.bounds.tolist() if sm.bounds is not None else None),
            "shard_vectors": sm.shard_sizes(
                self.index.cluster_sizes()).tolist(),
            "shard_scatters": self.sched.metrics.shard_scatters,
            "shard_parts": self.sched.metrics.shard_parts,
            "shard_merges": self.sched.metrics.shard_merges,
            "failovers": self.sched.metrics.failovers,
            "degraded_completions": self.sched.metrics.degraded_completions,
        }
        hyb = getattr(self.backend, "hybrid", None)
        if hyb is not None:
            out["per_owner_resident"] = hyb.cache.per_owner_resident()
        return out

    # ------------------------------------------------------- fault tolerance
    def write_journal(self, path: str) -> None:
        """Request journal: enough to replay / resume after a crash.

        One JSON row per line, written to a temp file and atomically
        ``os.replace``d into place — a crash mid-write leaves the previous
        journal intact instead of a truncated one, and a crash between
        write and rename at worst leaves a stale temp file behind."""
        rows = []
        for r in self.sched.done + self.sched.active + self.sched.pending:
            rows.append({
                "request_id": r.request_id,
                "graph": r.graph.name,
                "input": r.state.get("input"),
                "arrival_us": r.arrival_us,
                "finished": r.finished,
                "finish_us": r.finish_us,
                "events": [(t, e, _json_safe(p)) for t, e, p in r.events],
            })
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._sweep_journal_tmp(path)

    @staticmethod
    def _sweep_journal_tmp(path: str) -> None:
        """Remove orphaned ``<journal>.tmp.<pid>`` siblings.

        A crash between temp-file write and ``os.replace`` strands the temp
        file; since the pid suffix changes across restarts, those orphans
        would otherwise accumulate forever.  Swept on journal-backed server
        start and after each successful replace — at both points every
        surviving ``.tmp.*`` is known stale (this process's own temp file is
        already renamed away or not yet created)."""
        for stale in glob.glob(glob.escape(path) + ".tmp.*"):
            try:
                os.remove(stale)
            except OSError:
                pass  # concurrent sweep or permissions: leave it

    @staticmethod
    def read_journal(path: str) -> list[dict]:
        """All journal rows.  Reads the JSONL format (one request per line),
        tolerating a truncated trailing line from a crash mid-append; the
        legacy single-JSON-array format is still accepted."""
        with open(path) as f:
            text = f.read()
        if text.lstrip().startswith("["):  # legacy array journal
            return json.loads(text)
        rows = []
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # partial trailing row: drop it, keep the rest
                raise
        return rows

    @staticmethod
    def replay_unfinished(path: str) -> list[dict]:
        """Requests that must be re-admitted after restart."""
        return [r for r in Server.read_journal(path) if not r["finished"]]

    def readmit(self, rows: Iterable[dict]) -> list[Optional[int]]:
        """Re-admit journal rows (``replay_unfinished`` output) into this —
        possibly warm, possibly shard-mode — server: each row's workflow is
        rebuilt by name and re-queued at the later of its journaled arrival
        and the current event clock (the virtual clock cannot honor a stamp
        in its past).  The row's *original* request id is preserved (so
        per-request SLO/iteration draws and downstream trace joins survive
        the restart) unless a live request already holds it — then, and
        only then, a fresh id is allocated; the journaled partial event log
        is carried over so the post-restart trace keeps its pre-crash
        prefix.  Routing state (shard map, dispatcher, caches) is the live
        server's own, so recovered requests dispatch exactly like fresh
        ones.  Returns one request id per row (``None`` where an enabled
        admission knob sheds the recovered request)."""
        from repro_torch import workflows

        live = {r.request_id for r in (self.sched.done + self.sched.active
                                       + self.sched.pending)}
        ids: list[Optional[int]] = []
        for row in rows:
            graph = workflows.build(row["graph"])
            arrival = max(float(row.get("arrival_us", 0.0)), self.sched.now)
            rid = row.get("request_id")
            if rid is not None and int(rid) in live:
                rid = None  # collides with a live request: remap fresh
            req = self._build_request(row.get("input") or "", graph,
                                      arrival_us=arrival, request_id=rid)
            req.events = [
                (float(ev[0]), ev[1], ev[2] if len(ev) > 2 else None)
                for ev in row.get("events", ())
            ]
            if not self.sched.add_request(req):
                ids.append(None)
                continue
            live.add(req.request_id)
            ids.append(req.request_id)
        return ids

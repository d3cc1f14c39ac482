"""Wavefront scheduler + hybrid serving loop (paper §4.5, §5).

The loop models the paper's runtime: a *generation worker* (accelerator) and
a pool of ``num_ret_workers`` *retrieval workers* (host) execute
concurrently; whenever one goes idle the scheduler traverses the RAGraphs of
all in-flight requests in SLO-slack order, selects the next wavefront of
ready sub-nodes, applies graph transformations (split under the Eq.1 budget,
similarity reordering, speculative edges), and dispatches the transformed
sub-nodes to that worker's queue — retrieval sub-stages are placed by the
skew-aware policy in serving/dispatch.py (cluster affinity / least-loaded /
round-robin).  Time is tracked event-driven (worker completion / request
arrival), so baselines with coarse stages show their real head-of-line
blocking and the fine-grained mode shows real overlap — on any host,
including this single-CPU container, because work is *executed* exactly and
*charged* through the backend's per-worker timing model.

Modes (paper baselines, same loop, different policy switches):
  sequential  LangChain-like: whole-stage retrieval jobs, FIFO one at a time
  async       FlashRAG-like: whole-stage jobs, one-shot batch of all queued
  hedra       sub-stage splitting + dynamic batching + reorder/cache/spec +
              hot-cache device path
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from repro_torch.core import stages
from repro_torch.core.ownership import handoff, owned_by
from repro_torch.core.runtime import RequestContext, RuntimeDAG
from repro_torch.core.similarity import LocalCache
from repro_torch.core.speculation import SpeculationPolicy, Speculator
from repro_torch.core.substage import TimeBudget
from repro_torch.core import transforms
from repro_torch.retrieval.ivf import TopK
from repro_torch.retrieval.plan import (
    BatchTopK,
    PlanBuilder,
    gather_scatter_rows,
    make_gather_plan,
)
from repro_torch.serving import dispatch as dispatch_mod
from repro_torch.serving import lifecycle as lifecycle_mod

SPEC_RET_K = 20  # top-k width of speculative LocalCache warmups (paper k')


@dataclasses.dataclass
class SchedulerConfig:
    mode: str = "hedra"  # hedra | async | sequential
    nprobe: int = 64
    topk: int = 5
    enable_substage: bool = True
    enable_reorder: bool = True
    enable_early_term: bool = True
    early_term_mode: str = "heuristic"  # heuristic (paper) | lossless
    early_term_patience: int = 4  # clusters without top-k improvement
    enable_cache_answer: bool = True
    speculation: SpeculationPolicy = dataclasses.field(default_factory=SpeculationPolicy)
    max_gen_batch: int = 64
    sched_overhead_us: float = 120.0
    straggler_redispatch: bool = True
    straggler_cap: float = 2.0  # re-dispatch when > cap x expected
    slo_us: float = 10e6  # default; overridden per-request via RequestContext
    num_ret_workers: int = 1
    dispatch_policy: str = "affinity"  # affinity | least_loaded | round_robin
    # --- cross-request coordination (repro_torch.crossreq); all off by default,
    # in which case serving results are bit-identical to the uncoordinated
    # loop.  global_cache_size > 0 enables the shared semantic cache;
    # dedup_threshold > 0 enables in-flight query fusion in hedra mode
    # (1.0 = exact duplicates only, < 1.0 adds cosine-similar
    # near-duplicates, which are answered from the leader's result like an
    # O1 cache answer and are additionally gated by enable_cache_answer);
    # replication_factor > 1 replicates hot clusters across workers and
    # routes to replica holders (affinity policy, num_ret_workers > 1).
    global_cache_size: int = 0
    dedup_threshold: float = 0.0
    replication_factor: int = 1
    # --- streaming admission control (serving/dispatch.AdmissionController);
    # both off by default, in which case the pre-loaded batch path is
    # bit-identical to the legacy run-to-completion loop.  max_pending bounds
    # the arrival queue (0 = unbounded); admission_control additionally sheds
    # requests whose remaining SLO slack cannot cover a cost-model lower
    # bound of one pass over their graph, scaled by shed_margin.
    max_pending: int = 0
    admission_control: bool = False
    shed_margin: float = 1.0
    # --- distributed (shard-mode) retrieval: each retrieval worker owns a
    # contiguous cluster-range shard of the IVF table (retrieval.distributed
    # .ShardMap, balanced by vector mass); retrieval sub-stages are split by
    # owning shard into independent scatter tasks and the scheduler k-way
    # merges the partial top-k sets at completion — bit-identical to the
    # whole-index fold.  Off by default, in which case dispatch assumes
    # every worker sees the whole index and the serving path is
    # bit-identical to the unsharded loop.  shard_merge_us is the
    # cost-model charge per partial set folded at gather time (admission /
    # slack estimates model shard-mode service as max-over-shards + merge,
    # not a sum).
    index_sharding: bool = False
    shard_merge_us: float = 40.0
    # --- fault tolerance (serving/lifecycle.py + serving/faults.py): the
    # worker registry is always built (drain/rebind are operational APIs);
    # the *recovery* layer — per-job deadlines, retry/backoff of transiently
    # failed units, hedged duplicates for SUSPECT stragglers, shard failover
    # and degraded completion — activates when fault_tolerance is on or the
    # backend carries a FaultPlan.  With neither, the serving path is
    # bit-identical to the fault-unaware loop.  suspect/dead thresholds are
    # heartbeat-gap cutoffs on the virtual clock; timeout_factor scales the
    # cost-model charge into a per-job deadline; retry_budget bounds
    # re-dispatches per (request, node) before the unit completes degraded;
    # retry_backoff_us doubles per attempt; hedge_suspect duplicates
    # in-flight work of SUSPECT workers (first result wins);
    # failover_whole_index lets orphaned shard parts run on any serving
    # worker when no replica covers them (off: such parts degrade).
    fault_tolerance: bool = False
    # wall-clock serving (serving/ingress.py): heartbeats arrive as ingress
    # rows (Server.heartbeat_worker) instead of the always-fresh virtual
    # model, so real heartbeat gaps drive SUSPECT/DEAD detection.  Off by
    # default — with it off (and no FaultPlan) nothing ever transitions and
    # the loop is bit-identical to the heartbeat-unaware path.
    external_heartbeats: bool = False
    heartbeat_interval_us: float = 50_000.0
    suspect_after_us: float = 150_000.0
    dead_after_us: float = 400_000.0
    timeout_factor: float = 4.0
    retry_budget: int = 3
    retry_backoff_us: float = 20_000.0
    hedge_suspect: bool = True
    failover_whole_index: bool = True
    # --- observability (obs/): both layers are passive read-only taps —
    # enabling them changes no scheduling decision, RNG draw, or per-request
    # event log, so traces stay bit-identical to the knobs-off goldens.
    # tracing feeds an obs.trace.TraceRecorder (per-resource spans + flow
    # edges, exported as Chrome trace-event / Perfetto JSON and decomposed
    # by obs.attribution); telemetry attaches an
    # obs.registry.TelemetrySampler that samples queue depth, per-worker
    # utilization and lifecycle states every telemetry_interval_us of
    # virtual time into a labeled Prometheus-style registry.
    tracing: bool = False
    telemetry: bool = False
    telemetry_interval_us: float = 50_000.0

    @classmethod
    def preset(cls, mode: str, **kw) -> "SchedulerConfig":
        if mode == "hedra":
            return cls(mode="hedra", **kw)
        if mode == "async":
            base = dict(enable_substage=False, enable_reorder=False,
                        enable_early_term=False, enable_cache_answer=False,
                        speculation=SpeculationPolicy(mode="off"))
            base.update(kw)
            return cls(mode="async", **base)
        if mode == "sequential":
            base = dict(enable_substage=False, enable_reorder=False,
                        enable_early_term=False, enable_cache_answer=False,
                        speculation=SpeculationPolicy(mode="off"))
            base.update(kw)
            return cls(mode="sequential", **base)
        raise ValueError(mode)


# version of the summary()/window_summary() dict schema (bumped when keys
# are added/renamed/removed); documented in benchmarks/README.md
SUMMARY_SCHEMA_VERSION = 3


def _lat_ms(lat: "np.ndarray", q=None) -> float:
    """Latency statistic in milliseconds with the NaN-on-empty convention:
    ``q`` is a percentile (e.g. 50, 95), or None for the mean."""
    if not lat.size:
        return float("nan")
    v = lat.mean() if q is None else np.percentile(lat, q)
    return float(v / 1e3)


@dataclasses.dataclass
class Metrics:
    latencies_us: list = dataclasses.field(default_factory=list)
    finished: int = 0
    sim_time_us: float = 0.0
    gen_busy_us: float = 0.0
    # one slot per retrieval worker; ret_busy_us (total) is derived
    ret_busy_per_worker: list = dataclasses.field(default_factory=lambda: [0.0])
    gen_tokens: int = 0
    substages_gen: int = 0
    substages_ret: int = 0
    cache_answers: int = 0
    early_terms: int = 0
    reorders: int = 0
    spec_gen_attempts: int = 0
    spec_gen_validated: int = 0
    spec_gen_rollbacks: int = 0
    spec_ret_launches: int = 0
    straggler_redispatches: int = 0
    slo_violations: int = 0
    # cross-request coordination counters (all zero with crossreq disabled)
    global_cache_answers: int = 0
    global_cache_seeds: int = 0
    dedup_exact: int = 0
    dedup_near: int = 0
    dedup_fanout: int = 0
    dedup_saved_us: float = 0.0
    replica_routes: int = 0
    # hybrid-engine CacheStats snapshot, populated at the end of run()
    cache_stats: dict = dataclasses.field(default_factory=dict)
    # streaming admission + per-finish log: (finish_us, latency_us, under_slo)
    # rows power the window-based rates that exclude idle warmup/drain time
    submitted: int = 0
    shed_queue_full: int = 0
    shed_infeasible: int = 0
    # ingress re-admission accounting (serving/ingress.py closed loop): a
    # logical request's *first* shed bumps shed_*; every later attempt bumps
    # resubmissions only, and the attempt that finally lands bumps
    # shed_readmitted — so shed_final (= shed - shed_readmitted) counts
    # requests that actually left the system and the conservation identity
    # offered = submitted + shed_final holds with submitted = finished +
    # in_flight (each logical request is counted in exactly one bucket)
    resubmissions: int = 0
    shed_readmitted: int = 0
    finish_log: list = dataclasses.field(default_factory=list)
    # shard-mode scatter-gather counters (all zero with sharding disabled)
    shard_scatters: int = 0  # sub-stages split across shards
    shard_parts: int = 0  # partial scan tasks dispatched
    shard_merges: int = 0  # k-way gather merges completed
    # generic registry host stages (rerank / rewrite / compress / ...)
    stage_tasks: int = 0  # dispatched stage work batches / variant scans
    lexical_fusions: int = 0  # hybrid dense+lexical RRF folds applied
    # fault-tolerance counters (all zero with no faults and knobs off)
    worker_suspects: int = 0  # HEALTHY -> SUSPECT transitions
    worker_deaths: int = 0  # transitions into DEAD
    task_timeouts: int = 0  # jobs past their cost-model deadline
    redispatches: int = 0  # units lost on a dead worker, re-dispatched
    retries: int = 0  # transiently failed units re-dispatched
    transient_failures: int = 0  # injected transient unit failures observed
    hedged_dispatches: int = 0  # units duplicated onto idle workers
    hedged_wins: int = 0  # units completed by the hedge copy first
    failovers: int = 0  # shard parts routed off their dead/drained owner
    degraded_drops: int = 0  # units dropped after budget/coverage exhaustion
    degraded_completions: int = 0  # requests finished with partial results

    @property
    def ret_busy_us(self) -> float:
        return float(sum(self.ret_busy_per_worker))

    @property
    def shed(self) -> int:
        return self.shed_queue_full + self.shed_infeasible

    @property
    def shed_final(self) -> int:
        """Logical requests shed and never successfully re-admitted."""
        return self.shed - self.shed_readmitted

    # ------------------------------------------------------ windowed rates
    def window_summary(self, start_us: float, end_us: float) -> dict:
        """Rates/percentiles over finishes with ``start_us <= t < end_us``.

        ``summary()``'s ``throughput_rps`` divides by the *whole* simulated
        span including idle warmup and drain, which understates steady-state
        rates of streaming runs; this window variant is the streaming-side
        counterpart (goodput = finished under SLO per second)."""
        span = max(float(end_us) - float(start_us), 1e-9)
        rows = [f for f in self.finish_log if start_us <= f[0] < end_us]
        lat = np.asarray([l for _, l, _ in rows], np.float64)
        good = sum(1 for _, _, u in rows if u)
        out = {
            "schema_version": SUMMARY_SCHEMA_VERSION,
            "window_start_us": float(start_us),
            "window_end_us": float(end_us),
            "finished": len(rows),
            "finished_under_slo": int(good),
            "throughput_rps": len(rows) / (span / 1e6),
            "goodput_rps": good / (span / 1e6),
            "p50_latency_ms": _lat_ms(lat, 50),
            "p95_latency_ms": _lat_ms(lat, 95),
        }
        return {k: out[k] for k in sorted(out)}

    def goodput_timeline(self, window_us: float, step_us: float = 0.0) -> list:
        """Sliding-window goodput samples ``[(t_end_us, goodput_rps), ...]``
        stepping the window end by ``step_us`` (default: half a window) over
        the span of the finish log."""
        if not self.finish_log:
            return []
        window_us = float(window_us)
        step = float(step_us) if step_us > 0 else window_us / 2.0
        t0 = min(f[0] for f in self.finish_log)
        t1 = max(f[0] for f in self.finish_log)
        out = []
        t = t0 + window_us
        # at least one window even when the finish span is shorter than the
        # window — an empty list would be indistinguishable from no goodput
        t_end = max(t1 + step, t0 + window_us)
        while t <= t_end:
            good = sum(1 for f in self.finish_log
                       if t - window_us <= f[0] < t and f[2])
            out.append((float(t), good / (window_us / 1e6)))
            t += step
        return out

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_us, np.float64)
        t = max(self.sim_time_us, 1e-9)
        per = np.asarray(self.ret_busy_per_worker or [0.0], np.float64)
        util = per / t
        # steady-state window: [first finish, last finish) + the last finish
        # itself — excludes the idle warmup before the first completion and
        # any drain after the last one (a batch run with a single burst sees
        # roughly the same span as the legacy whole-run rates).  A
        # degenerate span (every finish at one event instant, e.g. one
        # generation batch completing together) has no meaningful rate —
        # fall back to the whole-run figures instead of dividing by ~0.
        if len(self.finish_log) >= 2:
            f0 = min(f[0] for f in self.finish_log)
            f1 = max(f[0] for f in self.finish_log)
            steady = (self.window_summary(f0, np.nextafter(f1, np.inf))
                      if f1 > f0 else None)
        else:
            steady = None
        good = sum(1 for _, _, u in self.finish_log if u)
        out = {
            "schema_version": SUMMARY_SCHEMA_VERSION,
            "finished": self.finished,
            "avg_latency_ms": _lat_ms(lat),
            "p50_latency_ms": _lat_ms(lat, 50),
            "p95_latency_ms": _lat_ms(lat, 95),
            "throughput_rps": self.finished / (t / 1e6),
            "goodput_rps": good / (t / 1e6),
            "steady_throughput_rps": steady["throughput_rps"]
            if steady else self.finished / (t / 1e6),
            "steady_goodput_rps": steady["goodput_rps"]
            if steady else good / (t / 1e6),
            "submitted": self.submitted,
            "shed": self.shed,
            "shed_queue_full": self.shed_queue_full,
            "shed_infeasible": self.shed_infeasible,
            "resubmissions": self.resubmissions,
            "shed_readmitted": self.shed_readmitted,
            "shed_final": self.shed_final,
            "gen_util": self.gen_busy_us / t,
            "num_ret_workers": int(per.size),
            "ret_util": float(util.mean()),
            "ret_util_min": float(util.min()),
            "ret_util_max": float(util.max()),
            "ret_worker_skew": float(util.max() / util.mean())
            if util.mean() > 0 else 1.0,
            "gen_tokens": self.gen_tokens,
            "substages_gen": self.substages_gen,
            "substages_ret": self.substages_ret,
            "cache_answers": self.cache_answers,
            "early_terms": self.early_terms,
            "spec_gen_attempts": self.spec_gen_attempts,
            "spec_gen_validated": self.spec_gen_validated,
            "spec_gen_rollbacks": self.spec_gen_rollbacks,
            "spec_ret_launches": self.spec_ret_launches,
            "straggler_redispatches": self.straggler_redispatches,
            "slo_violations": self.slo_violations,
            "global_cache_answers": self.global_cache_answers,
            "global_cache_seeds": self.global_cache_seeds,
            "dedup_exact": self.dedup_exact,
            "dedup_near": self.dedup_near,
            "dedup_fanout": self.dedup_fanout,
            "dedup_saved_ms": float(self.dedup_saved_us / 1e3),
            "replica_routes": self.replica_routes,
            "shard_scatters": self.shard_scatters,
            "shard_parts": self.shard_parts,
            "shard_merges": self.shard_merges,
            "stage_tasks": self.stage_tasks,
            "lexical_fusions": self.lexical_fusions,
            "worker_suspects": self.worker_suspects,
            "worker_deaths": self.worker_deaths,
            "task_timeouts": self.task_timeouts,
            "redispatches": self.redispatches,
            "retries": self.retries,
            "transient_failures": self.transient_failures,
            "hedged_dispatches": self.hedged_dispatches,
            "hedged_wins": self.hedged_wins,
            "failovers": self.failovers,
            "degraded_drops": self.degraded_drops,
            "degraded_completions": self.degraded_completions,
            # hybrid-engine counters, surfaced so benches/--json records see
            # them without reaching into the backend
            "cache_hit_rate": float(self.cache_stats.get("hit_rate", 0.0)),
            "cache_oversized_rejects": int(
                self.cache_stats.get("oversized_rejects", 0)),
            "cache_stale_fallbacks": int(
                self.cache_stats.get("stale_fallbacks", 0)),
            "cache_replica_loads": int(
                self.cache_stats.get("replica_loads", 0)),
            "cache_replicated_clusters": int(
                self.cache_stats.get("replicated_clusters", 0)),
        }
        # deterministic key order: consumers diffing two summaries (or
        # serializing to JSON without sort_keys) see a stable layout
        return {k: out[k] for k in sorted(out)}


@dataclasses.dataclass
class _ShardGather:
    """One in-flight scatter set: a retrieval sub-stage split into per-shard
    partial scans.  Each completing part writes its item rows into ``board``
    (original probe order); when the last part lands, ``plan`` — the
    one-group whole-index replay plan carrying the stage's seed top-k and
    early-termination streak state — folds the board, so the merged result
    is bit-identical to a single worker scanning the whole probe list."""

    req: RequestContext
    sn: object  # runtime-DAG sub-node covering the scatter set
    clusters: list  # dispatched clusters, in probe (fold) order
    plan: object  # replay RetrievalPlan (one group)
    board: BatchTopK  # (n_clusters, plan.k) partial item rows
    remaining: int  # parts still in flight


@dataclasses.dataclass
class _FaultState:
    """Recovery-layer bookkeeping, built only when fault tolerance is active
    (``SchedulerConfig.fault_tolerance`` or a backend ``FaultPlan``).

    Every dispatched *unit* of retrieval-side work (sub-stage plan group,
    shard scatter part, registry stage plan group, host StageTask) gets a
    token; ``units[token]`` tracks how many in-flight copies exist (1, or 2
    while a hedge twin runs) and whether one already resolved — the
    first-result-wins dedup that makes hedging and late fenced results safe
    to apply exactly once."""

    plan: object = None  # serving.faults.FaultPlan (may be None)
    dispatch_seq: int = 0  # monotone counter feeding transient-fault draws
    next_token: int = 0
    units: dict = dataclasses.field(default_factory=dict)
    # (request_id, node_id) -> transient-retry attempts consumed
    attempts: dict = dataclasses.field(default_factory=dict)
    # request_id -> earliest virtual instant a retried unit may re-dispatch
    not_before: dict = dataclasses.field(default_factory=dict)
    # shard scatter parts lost on a dead worker: [(gather, positions), ...]
    orphan_parts: list = dataclasses.field(default_factory=list)


@owned_by("scheduler", expose=("metrics", "crossreq", "obs", "telemetry",
                               "lifecycle", "shard_map"))
class WavefrontScheduler:
    def __init__(self, backend, index, config: SchedulerConfig,
                 workload=None):
        from repro_torch.serving.workload import WorkloadProfile

        self.backend = backend
        self.index = index
        self.cfg = config
        self.workload = workload or WorkloadProfile()
        self.dag = RuntimeDAG()
        self.budget = TimeBudget()
        self.spec = Speculator(config.speculation)
        self.num_ret_workers = max(1, int(config.num_ret_workers))
        # cross-request coordination layer (repro_torch.crossreq): built only when
        # a knob enables it, so the disabled path stays bit-identical
        self.crossreq = None
        self._merge_unique = None
        if (config.global_cache_size > 0 or config.dedup_threshold > 0.0
                or config.replication_factor > 1):
            from repro_torch.crossreq import CrossRequestCoordinator
            from repro_torch.crossreq.globalcache import merge_unique

            self.crossreq = CrossRequestCoordinator(
                config, index, self.num_ret_workers)
            self._merge_unique = merge_unique
            hyb = getattr(backend, "hybrid", None)
            if (hyb is not None and config.replication_factor > 1
                    and self.num_ret_workers > 1):
                self.crossreq.attach_cache(
                    hyb.cache, self.num_ret_workers,
                    config.replication_factor)
        # shard-mode serving (retrieval.distributed.ShardMap): one contiguous
        # cluster-range shard per retrieval worker; built only when the knob
        # is on so the disabled path stays bit-identical to the unsharded
        # loop
        self.shard_map = None
        if config.index_sharding:
            from repro_torch.retrieval.distributed import ShardMap

            self.shard_map = ShardMap.build(
                index.cluster_sizes(), self.num_ret_workers)
            hyb = getattr(backend, "hybrid", None)
            if hyb is not None and not hyb.sharded:
                hyb.enable_sharding(self.shard_map.owner,
                                    self.num_ret_workers)
        self.dispatcher = dispatch_mod.RetrievalDispatcher(
            self.num_ret_workers, index.n_clusters,
            policy=config.dispatch_policy,
            tracker=self.crossreq.tracker if self.crossreq else None,
            replica_map=self.crossreq.replicas if self.crossreq else None,
            shard_map=self.shard_map)
        # worker lifecycle registry: always built (drain/rebind are
        # operational APIs); with no fault plan and no drain calls every
        # worker stays HEALTHY and the loop is unchanged.  The *recovery*
        # machinery (_FaultState) activates only on an explicit knob or plan.
        self.lifecycle = lifecycle_mod.WorkerRegistry(
            self.num_ret_workers,
            heartbeat_interval_us=config.heartbeat_interval_us,
            suspect_after_us=config.suspect_after_us,
            dead_after_us=config.dead_after_us,
            external_heartbeats=config.external_heartbeats)
        fault_plan = getattr(backend, "fault_plan", None)
        self.ft: Optional[_FaultState] = None
        if config.fault_tolerance or fault_plan is not None:
            self.ft = _FaultState(plan=fault_plan)
        self.metrics = Metrics()
        self.metrics.ret_busy_per_worker = [0.0] * self.num_ret_workers
        # observability taps (obs/): lazily imported so the default path
        # never loads the package; both are purely passive recorders
        self.obs = None
        self.telemetry = None
        if config.tracing:
            from repro_torch.obs.trace import TraceRecorder

            self.obs = TraceRecorder()
        if config.telemetry:
            from repro_torch.obs.registry import TelemetrySampler

            self.telemetry = TelemetrySampler(
                interval_us=config.telemetry_interval_us)
        # arrival queue: heap keyed (arrival_us, ingress_seq) — O(log n)
        # admission instead of the old sort-on-every-insert list.  The
        # monotonic admission sequence number breaks exact-arrival ties in
        # *submission* order: request ids are allocated before admission, so
        # tying on request_id would let concurrent wall-clock submits replay
        # in a different order than they ran
        self._pending: list[tuple[float, int, RequestContext]] = []
        self._ingress_seq = 0
        self.active: list[RequestContext] = []
        self.done: list[RequestContext] = []
        self._cluster_sizes = index.cluster_sizes()
        # streaming event-loop state: lives on the instance so step() can
        # leave jobs in flight between calls and submissions can interleave
        self.now = 0.0
        self._gen_job = None
        self._ret_jobs: list = [None] * self.num_ret_workers
        self.admission = None
        if config.max_pending > 0 or config.admission_control:
            self.admission = dispatch_mod.AdmissionController(
                config, self.budget, self.backend.cluster_cost_model,
                self._cluster_sizes, shard_map=self.shard_map,
                lifecycle=self.lifecycle)
        self._ret_fifo: list[RequestContext] = []  # coarse-mode stage queue
        self._spec_ret_round: dict[int, int] = {}  # req -> last spec-ret round
        # request_id -> (query_vec, cluster queue) precomputed in one batched
        # probe_order call for all arrivals admitted in the same cycle
        self._probe_hints: dict[int, tuple] = {}
        # consecutive no-event cycles: trips the stranded-work degrade net
        self._idle_cycles = 0

    # ------------------------------------------------------------------ API
    @property
    def pending(self) -> list[RequestContext]:
        """Queued (not yet admitted-to-active) requests in arrival order
        (submission order at exact arrival ties)."""
        return [item[2] for item in sorted(self._pending, key=lambda x: x[:2])]

    @handoff("server")
    def add_request(self, req: RequestContext) -> bool:
        """Queue a request for admission at its arrival time.  Returns False
        when the admission layer sheds it (bounded queue / infeasible
        deadline) — only possible when a SchedulerConfig admission knob is
        enabled; the default configuration admits unconditionally.

        A request carrying the ``_shed`` state marker is a *re-admission
        attempt* of a previously shed logical request (the ingress loop's
        closed-loop retry): it bumps ``resubmissions`` instead of
        re-counting ``shed_*`` on failure, and bumps ``shed_readmitted``
        when it finally lands, so each logical request is counted in
        exactly one of {submitted, shed_final}."""
        resubmit = "_shed" in req.state
        if resubmit:
            self.metrics.resubmissions += 1
        if self.admission is not None:
            in_system = len(self._pending) + len(self.active)
            dec = self.admission.evaluate(req, self.now, in_system,
                                          active=self.active)
            if not dec.admitted:
                if not resubmit:
                    # first shed of this logical request: count it and fire
                    # the obs hooks exactly once
                    if dec.reason == "queue_full":
                        self.metrics.shed_queue_full += 1
                    else:
                        self.metrics.shed_infeasible += 1
                    if self.obs is not None:
                        self.obs.request_shed(req, self.now, dec.reason)
                    if self.telemetry is not None:
                        self.telemetry.on_shed(req, dec.reason)
                req.state["_shed"] = dec.reason
                return False
        if resubmit:
            del req.state["_shed"]
            self.metrics.shed_readmitted += 1
        self.metrics.submitted += 1
        if self.obs is not None:
            self.obs.request_submitted(req, self.now)
        req.ingress_seq = self._ingress_seq
        self._ingress_seq += 1
        heapq.heappush(self._pending,
                       (float(req.arrival_us), req.ingress_seq, req))
        return True

    # ------------------------------------------------- worker pool lifecycle
    @handoff("server")
    def register_worker(self) -> int:
        """Add a fresh retrieval worker to the pool mid-run.  The new worker
        starts HEALTHY and owns no shard — in shard mode it serves stage
        work, replica scans and whole-index failover until a resharding
        assigns it clusters."""
        wid = self.lifecycle.register(self.now)
        self.num_ret_workers += 1
        self.cfg.num_ret_workers = self.num_ret_workers
        self._ret_jobs.append(None)
        self.metrics.ret_busy_per_worker.append(0.0)
        self.dispatcher.add_worker()
        return wid

    @handoff("server")
    def drain_worker(self, wid: int) -> bool:
        """Operator-initiated leave: the worker finishes its in-flight job
        and takes no new work until ``rebind_worker``."""
        return self.lifecycle.drain(int(wid), self.now)

    @handoff("server")
    def rebind_worker(self, wid: int) -> bool:
        """Return a drained worker to the pool (JOINING -> HEALTHY)."""
        return self.lifecycle.rebind(int(wid), self.now)

    @handoff("server")
    def worker_heartbeat(self, wid: int, now: float) -> None:
        """External (ingress-fed) heartbeat for ``wid`` stamped ``now`` on
        the virtual clock.  The registry clamps: a stamp behind the last
        one recorded never regresses ``last_heartbeat_us``.  Only
        meaningful with ``external_heartbeats`` on — the default virtual
        model keeps live workers fresh without any feed."""
        self.lifecycle.heartbeat(int(wid), float(now))

    @handoff("server")
    def admission_load(self) -> dict:
        """Backlog snapshot for the ingress re-admission gate: in-system
        population, the bounded-queue limit (0 = unbounded), and the
        admission controller's in-flight backlog estimate (µs)."""
        out = {"in_system": len(self._pending) + len(self.active),
               "max_pending": int(self.cfg.max_pending),
               "backlog_us": 0.0}
        if self.admission is not None:
            out["backlog_us"] = float(self.admission.backlog_us(self.active))
        return out

    # -------------------------------------------------------------- helpers
    def _enter_stage(self, req: RequestContext, now: float) -> None:
        """(Re)initialise progress when a request sits at a fresh node.
        Loops through instant completions (cache answers / empty nodes)."""
        while True:
            if req.finished:
                return
            if req.current is None:
                req.start()
            if stages.spec_for(req.node).enter(self, req, now):
                continue  # stage completed instantly; next may be instant too
            return

    def _finish_ret_stage(self, req: RequestContext, now: float) -> None:
        node = req.node
        assert req.ret is not None
        stages.spec_for(node).write_output(self, req, now)
        req.sim_cache.update(req.ret.query_vec, req.ret.topk, self.index,
                             req.ret.searched)
        if req.ret.started_at >= 0:
            self.budget.observe_retrieval_stage(now - req.ret.started_at)
        req.round_idx += 1
        req.log(now, "ret_stage_done", node.node_id)
        if self.crossreq is not None:
            self._crossreq_stage_done(req, now)
        # speculation resolution (dependency rewiring)
        if req.gen is not None and req.gen.speculative_src is not None:
            self.metrics.spec_gen_attempts += 1
            ok = transforms.validate_or_rollback(self.dag, req, self.spec)
            if ok:
                self.metrics.spec_gen_validated += 1
            else:
                self.metrics.spec_gen_rollbacks += 1
            # move to the generation node, keeping (or restarting) gen progress
            nxt = req.graph.successor(req.current, req.state)
            req.ret = None
            from repro_torch.core.ragraph import END

            if nxt is END:
                self._finish_request(req, now)
            else:
                req.current = int(nxt)
                if req.gen is not None:
                    req.gen.started_at = now if req.gen.started_at < 0 else req.gen.started_at
                    # validated speculation that already finished generating
                    if req.gen.done and req.gen.speculative_src is None:
                        self._finish_gen_stage(req, now)
            return
        req.ret = None
        self._advance_request(req, now)

    def _advance_request(self, req: RequestContext, now: float) -> None:
        """Shared stage-completion tail: advance to the successor node (or
        finish), preserving speculative generation progress across the hop."""
        gen_keep = req.gen
        if req.advance():
            # only restore generation progress onto the node it belongs to —
            # an unconditional restore can resurrect stale progress onto an
            # unrelated successor (e.g. the next node of a ret->ret chain)
            if (gen_keep is not None
                    and stages.spec_for(req.node).resource == stages.GEN
                    and gen_keep.node_id in (None, req.current)):
                req.gen = gen_keep
            self._enter_stage(req, now)
        else:
            self._finish_request(req, now)

    def _finish_stage(self, req: RequestContext, now: float) -> None:
        """Completion of a generic registry host stage (any kind beyond the
        dedicated gen/ret paths): fold the result into request state, feed
        the stage time into the Eq.(1) budget EMA, fan the output out to
        fused subscribers, and advance."""
        prog = req.stage
        assert prog is not None
        sp = stages.spec(prog.kind)
        node = req.node
        sp.write_output(self, req, now)
        if prog.started_at >= 0:
            self.budget.observe_retrieval_stage(now - prog.started_at)
        req.log(now, f"{prog.kind}_stage_done", node.node_id)
        if self.crossreq is not None and self.crossreq.fusion is not None:
            for sub, match in self.crossreq.fusion.complete_leader(
                    req.request_id):
                if (sub.finished or sub.stage is None
                        or not sub.stage.parked):
                    continue
                self.metrics.dedup_fanout += 1
                if self.obs is not None:
                    self.obs.fanout(req, sub, now, "stage")
                sp.adopt_from_leader(self, sub, req, match, now)
        req.stage = None
        self._advance_request(req, now)

    def _crossreq_stage_done(self, req: RequestContext, now: float) -> None:
        """Cross-request hooks at retrieval-stage completion: publish the
        finished search into the global cache (stages that actually
        searched — cache-answered and fanned-out stages carry no new
        information), then fan the merged top-k out to every fused
        subscriber so their stages complete at the same instant."""
        cr = self.crossreq
        ret = req.ret
        if (cr.global_cache is not None and ret.searched
                and not ret.answered_from_cache):
            wide = getattr(ret, "_wide_topk", None)
            cr.global_cache.insert(ret.query_vec,
                                   wide if wide is not None else ret.topk,
                                   self.index, list(ret.searched), ret.nprobe)
        if cr.fusion is None:
            return
        final = ret.topk
        searched = list(ret.searched)
        for sub, kind in cr.fusion.complete_leader(req.request_id):
            if sub.finished or sub.ret is None or sub.ret.done:
                continue
            k = sub.ret.k
            sub.ret.topk = TopK(k, final.dists[:k].copy(),
                                final.ids[:k].copy())
            if kind == "near":
                # the fanned-out distances are relative to the *leader's*
                # query; record that query in the subscriber's LocalCache
                # so the next round's O1 ball bound stays sound instead of
                # silently compounding the single-hop fusion tolerance
                sub.ret.query_vec = ret.query_vec.copy()
            sub.ret.searched = list(searched)
            sub.ret.answered_from_cache = True
            sub.ret.cluster_queue = []
            sub.ret._inflight = False  # type: ignore[attr-defined]
            self.metrics.dedup_fanout += 1
            if self.obs is not None:
                self.obs.fanout(req, sub, now, kind)
            self._finish_ret_stage(sub, now)

    def _finish_gen_stage(self, req: RequestContext, now: float) -> None:
        node = req.node
        assert req.gen is not None
        req.state[node.output] = {
            "tokens": req.gen.generated,
            "text": f"<gen:{req.request_id}:{node.node_id}>",
        }
        req.state.setdefault("_gen_history", []).append(node.node_id)
        self.metrics.gen_tokens += req.gen.generated
        req.gen_round += 1
        req.log(now, "gen_stage_done", node.node_id)
        req.gen = None
        if req.advance():
            self._enter_stage(req, now)
        else:
            self._finish_request(req, now)

    def _finish_request(self, req: RequestContext, now: float) -> None:
        req.finish_us = now
        lat = now - req.arrival_us
        self.metrics.latencies_us.append(lat)
        under_slo = lat <= (req.slo_us or self.cfg.slo_us)
        if not under_slo:
            self.metrics.slo_violations += 1
        self.metrics.finish_log.append((now, lat, under_slo))
        self.metrics.finished += 1
        if req.state.get("_degraded"):
            self.metrics.degraded_completions += 1
        self.active.remove(req)
        self.done.append(req)
        if self.obs is not None:
            self.obs.request_finished(req, now)
        if self.telemetry is not None:
            self.telemetry.on_finish(req, now)
        self.dag.gc()

    def _prime_probe_orders(self, reqs: list, now: float) -> None:
        """Batch the nprobe ranking for all arrivals admitted this cycle:
        one ``probe_order`` call per distinct nprobe instead of one per
        request.  Results are stashed as hints consumed by ``_enter_stage``."""
        by_nprobe: dict[int, list] = {}
        for r in reqs:
            if r.finished or r.ret is not None:
                continue
            nid = r.current if r.current is not None else r.graph.entry()
            node = r.graph.nodes.get(nid)
            if node is None:
                continue
            nprobe = stages.spec_for(node).probe_hint_nprobe(node, self.cfg)
            if nprobe is None:
                continue
            qv = self.backend.query_embedding(r, r.round_idx)
            by_nprobe.setdefault(nprobe, []).append((r, qv))
        for nprobe, lst in by_nprobe.items():
            order = self.index.probe_order(
                np.stack([qv for _, qv in lst]), nprobe)
            for (r, qv), row in zip(lst, order):
                self._probe_hints[r.request_id] = (
                    qv, [int(c) for c in row])

    # ------------------------------------------------------ work assembly
    def _slack_order(self, reqs, now: float) -> list:
        """Wavefront order: tightest SLO slack admitted to assembly first.
        In shard mode remaining-time estimates use the scatter-gather
        service model (max over shards + merge term).  With workers dead or
        draining, per-request estimates inflate by the static/effective pool
        ratio so slack ordering sees the shrunken pool."""
        scale = 1.0
        if not self.lifecycle.all_healthy():
            eff = self.lifecycle.effective_pool_size()
            if 0 < eff < self.num_ret_workers:
                scale = self.num_ret_workers / eff
        return dispatch_mod.order_by_slack(
            reqs, now, self.budget, self.backend.cluster_cost_model,
            self._cluster_sizes, self.cfg.slo_us, self.shard_map,
            self.cfg.shard_merge_us if self.shard_map is not None else 0.0,
            pool_scale=scale)

    def _assemble_gen(self, now: float):
        """Continuous-batching generation sub-stage across requests."""
        ready = [
            r for r in self.active
            if r.gen is not None and not r.gen.done
            and r.gen.engine_seq != "inflight"
        ]
        batch = self._slack_order(ready, now)[: self.cfg.max_gen_batch]
        if not batch:
            return None
        n_steps = self.budget.gen_steps_for_budget(len(batch))
        n_prefill_tokens = sum(
            self.workload.prompt_tokens(r.request_id, r.current or 0)
            for r in batch if not r.gen.prefilled
        )
        dur = self.backend.gen_duration(n_prefill_tokens, len(batch), n_steps)
        dur = self._mitigate_straggler(dur, expected=dur)
        for r in batch:
            r.gen.engine_seq = "inflight"
        self.metrics.substages_gen += 1
        return {"reqs": batch, "n_steps": n_steps, "end": now + dur, "dur": dur}

    def _assemble_ret(self, now: float, idle: list[int]) -> dict:
        """Assemble retrieval jobs for the idle workers; returns {wid: job}."""
        if self.crossreq is not None:
            # decay the shared popularity histogram and refresh the replica
            # map once per assembly cycle
            self.crossreq.tick()
        if self.cfg.mode == "hedra":
            return self._assemble_ret_substage(now, idle)
        return self._assemble_ret_coarse(now, idle)

    def _finalize_ret_job(self, now: float, wid: int, plan,
                          tasks=(), hedge_tokens=None) -> dict:
        charge = 0.0
        results_fn = None
        if plan is not None:
            charge, results_fn = self.backend.search_charged(plan,
                                                             worker_id=wid)
        task_runs = []
        for t in tasks:
            c, fn = self.backend.stage_charged(t, worker_id=wid)
            charge += c
            task_runs.append((t, fn))
        dur = self._mitigate_straggler(charge, expected=charge, worker_id=wid)
        if self.ft is not None and self.ft.plan is not None:
            # injected stall windows inflate service time *after* straggler
            # mitigation — they are exactly what the timeout/hedging layer
            # must cover, so the cap must not silently absorb them
            dur = self.backend.fault_latency(dur, worker_id=wid, now_us=now)
        self.dispatcher.note_busy(wid, dur)
        self.metrics.substages_ret += 1
        job = {"plan": plan, "results_fn": results_fn, "tasks": task_runs,
               "end": now + dur, "dur": dur, "worker": wid}
        if self.ft is not None:
            job["deadline"] = (now + charge * self.cfg.timeout_factor
                               + self.cfg.sched_overhead_us)
            self._ft_register_job(job, wid, hedge_tokens)
        if self.obs is not None:
            self.obs.ret_job(job, wid, now, hedge=hedge_tokens is not None)
        if self.telemetry is not None:
            self.telemetry.on_ret_job(job, wid)
        return job

    def _add_ret_group(self, builder: PlanBuilder, r: RequestContext,
                       clusters, sn) -> None:
        """One plan group per request sub-stage, seeded with the running
        top-k and the early-termination streak state at assembly time.
        A fused leader's group carries its current subscriber fan-out so
        the backend charges the group once for the whole set."""
        fanout = 1
        out_k = None
        if self.crossreq is not None:
            if self.crossreq.fusion is not None:
                fanout = self.crossreq.fusion.fanout(r.request_id)
            if self.crossreq.global_cache is not None:
                # widen the scoreboard (not group_k: streaks and returned
                # results are untouched) so the stage can publish a top-k'
                # entry to the global cache at no extra scan cost
                out_k = max(r.ret.topk.k, SPEC_RET_K)
        builder.add(
            r.ret.query_vec, clusters,
            k=r.ret.topk.k,
            meta=("ret", r, sn, list(clusters)),
            seed=r.ret.topk,
            last_kth=r.ret.last_kth,
            no_improve=r.ret.no_improve,
            fanout=fanout,
            out_k=out_k,
        )

    # ------------------------------------------------ shard scatter-gather
    def _scatter_ret(self, builders: dict, cycle_load: dict,
                     r: RequestContext, idle: list[int], cm, now: float,
                     *, whole_stage: bool) -> None:
        """Shard-mode dispatch of one request's next retrieval sub-stage:
        take the Eq.(1) budget prefix of the (reordered) cluster queue (the
        whole queue for coarse stages), split it by owning shard, and hand
        each part to its owner — or, for hot clusters replicated onto other
        workers' slabs, to the least-loaded replica holder.  Parts whose
        eligible workers are all busy stay queued (order preserved) for a
        later cycle; the dispatched parts form one ``_ShardGather`` whose
        completion performs the whole-index k-way merge.

        When the pool is impaired, parts whose owner is DEAD or DRAINING
        fail over (replica holder, then whole-index-capable worker); parts
        nothing can ever cover are dropped and the stage completes degraded
        rather than hanging."""
        queue = r.ret.cluster_queue
        if not queue:
            return
        if whole_stage:
            n = len(queue)
        else:
            n = self.budget.clusters_for_budget(queue, cm,
                                                self._cluster_sizes)
        prefix = queue[:n]
        assign = []
        taken = set()
        dropped = set()
        impaired = not self.lifecycle.all_healthy()
        for shard, part in self.shard_map.split(prefix):
            if impaired and not self.lifecycle.owner_serves(shard):
                wid, can_wait = self._pick_failover_worker(part, idle,
                                                           cycle_load)
                if wid is not None:
                    assign.append((shard, wid, part))
                    taken.add(shard)
                    self.metrics.failovers += 1
                    if self.obs is not None:
                        self.obs.failover(r, wid, now)
                elif not can_wait:
                    dropped.add(shard)
                continue
            wid = self.dispatcher.pick_shard_worker(part, shard, idle,
                                                    extra_load=cycle_load)
            if wid is not None:
                assign.append((shard, wid, part))
                taken.add(shard)
        if not assign and not dropped:
            return
        own = self.shard_map.owner
        dispatched = [c for c in prefix if int(own[c]) in taken]
        r.ret.cluster_queue = (
            [c for c in prefix
             if int(own[c]) not in taken and int(own[c]) not in dropped]
            + queue[n:])
        if dropped:
            self.metrics.degraded_drops += len(dropped)
            self._flag_degraded(r, now)
        if not assign:
            # every placeable part degraded away; the stage may now be done
            if r.ret.done:
                self._finish_ret_stage(r, now)
            return
        gather = self._new_gather(r, dispatched, len(assign))
        owners = self.shard_map.owner_of(dispatched)
        fanout = 1
        if self.crossreq is not None and self.crossreq.fusion is not None:
            fanout = self.crossreq.fusion.fanout(r.request_id)
        for shard, wid, part in assign:
            positions = np.flatnonzero(owners == shard)
            builders[wid].add(
                r.ret.query_vec, part, k=r.ret.topk.k,
                meta=("shard", gather, positions),
                fanout=fanout, out_k=gather.board.k)
            self.dispatcher.note_dispatch(wid, part)
            cycle_load[wid] = cycle_load.get(wid, 0.0) + cm.batch_cost_us(
                self._cluster_sizes[np.asarray(part, np.int64)])
            self.metrics.shard_parts += 1
        r.ret._inflight = True  # type: ignore[attr-defined]
        self.metrics.shard_scatters += 1

    def _new_gather(self, r: RequestContext, clusters: list,
                    n_parts: int) -> _ShardGather:
        """Open a scatter set: the runtime-DAG sub-node covering it plus the
        one-group replay plan seeded with the stage's running top-k and
        early-termination streaks (widened to top-k' when the global cache
        wants a publishable entry, like the whole-index path)."""
        sn = self.dag.new_subnode(r, "ret", {"clusters": list(clusters)})
        out_k = None
        if (self.crossreq is not None
                and self.crossreq.global_cache is not None):
            out_k = max(r.ret.topk.k, SPEC_RET_K)
        plan = make_gather_plan(
            r.ret.query_vec, clusters, k=r.ret.topk.k, seed=r.ret.topk,
            last_kth=r.ret.last_kth, no_improve=r.ret.no_improve,
            out_k=out_k)
        return _ShardGather(
            req=r, sn=sn, clusters=list(clusters), plan=plan,
            board=BatchTopK.empty(len(clusters), plan.k),
            remaining=int(n_parts))

    def _finish_gather(self, gather: _ShardGather, now: float) -> None:
        """All parts of a scatter set have landed: fold the board with the
        replay plan (k-way merge, bit-identical to the whole-index path) and
        run the same stage-completion logic the unsharded path runs."""
        r = gather.req
        self.metrics.shard_merges += 1
        if self.obs is not None:
            self.obs.gather_merge(gather, now)
        if r.finished or r.ret is None:
            return
        res = gather.plan.finalize(gather.board)
        self._apply_ret_result(r, res, 0, int(gather.plan.group_k[0]),
                               gather.plan.k, gather.clusters, gather.sn, now)

    def _apply_ret_result(self, r: RequestContext, res, g: int, kg: int,
                          plan_k: int, clusters, sn, now: float) -> None:
        """Stage-completion core shared by the whole-index path
        (``_complete_ret``'s ``ret`` groups) and the shard-mode gather: fold
        group ``g`` of ``res`` into the request's running state, tick the
        early-termination check, and close the stage when it is done.  Both
        paths MUST go through here — the shard-mode bit-identity guarantee
        is exactly that the two run the same completion logic."""
        r.ret.topk = res.group_topk(g, kg)
        if (self.crossreq is not None
                and self.crossreq.global_cache is not None
                and plan_k > kg):
            # accumulate the widened top-k' entry for the global cache
            # across the stage's sub-stages; id dedup keeps the shared
            # seed prefix from duplicating
            row = res.group_topk(g, plan_k)
            prev = getattr(r.ret, "_wide_topk", None)
            r.ret._wide_topk = (  # type: ignore[attr-defined]
                row if prev is None
                else self._merge_unique(prev, row, plan_k))
        r.ret.no_improve = int(res.no_improve[g])
        r.ret.last_kth = float(res.last_kth[g])
        r.ret.searched.extend(clusters)
        r.ret._inflight = False  # type: ignore[attr-defined]
        if sn is not None:
            self.dag.complete(sn)
        if self.cfg.enable_early_term and not r.ret.done:
            if transforms.maybe_early_terminate(
                    self.index, r, mode=self.cfg.early_term_mode,
                    patience=self.cfg.early_term_patience):
                self.metrics.early_terms += 1
        if r.ret.done:
            self._finish_ret_stage(r, now)
        elif (self.shard_map is not None and self.cfg.mode != "hedra"
              and r not in self._ret_fifo):
            # coarse shard-mode stage with deferred parts (busy owners at
            # dispatch): back into the stage queue for the next assembly
            self._ret_fifo.append(r)

    def _assemble_ret_substage(self, now: float, idle: list[int]) -> dict:
        builders: dict[int, PlanBuilder] = {w: PlanBuilder() for w in idle}
        # estimated cost handed to each worker *this cycle*; lets the
        # dispatcher spread simultaneous sub-stages instead of piling them
        # onto the worker that was least loaded when the cycle started
        cycle_load: dict[int, float] = {w: 0.0 for w in idle}
        tasks: dict[int, list] = {w: [] for w in idle}
        cm = self.backend.cluster_cost_model
        if (self.ft is not None and self.ft.orphan_parts
                and self.shard_map is not None):
            self._place_orphans(builders, cycle_load, idle, now)
        nb = self.ft.not_before if self.ft is not None else None
        ready = [r for r in self.active
                 if (nb is None or nb.get(r.request_id, 0.0) <= now)
                 and ((r.ret is not None and not r.ret.done
                       and not getattr(r.ret, "_inflight", False))
                      or (r.stage is not None and not r.stage.done
                          and not r.stage.parked and r.stage.work_queue))]
        ordered = self._slack_order(ready, now)
        if self.crossreq is not None and self.crossreq.fusion is not None:
            ordered = self._fuse_wavefront(ordered)
        for r in ordered:
            if r.stage is not None:
                # generic registry stage: the spec splits its own work-unit
                # queue under the budget and dispatches plan groups and/or
                # host StageTasks (shard mode included — host arrays hold
                # the whole index, so stage work is placement-free)
                stages.spec(r.stage.kind).assemble(
                    self, r, builders, tasks, cycle_load, idle, now,
                    whole_stage=False)
                continue
            if self.shard_map is not None:
                self._scatter_ret(builders, cycle_load, r, idle, cm, now,
                                  whole_stage=False)
                continue
            sn = transforms.split_retrieval_next(
                self.dag, r, self.budget, cm, self._cluster_sizes,
            )
            if sn is None:
                continue
            clusters = sn.payload["clusters"]
            wid = self.dispatcher.pick_worker(clusters, idle,
                                              extra_load=cycle_load)
            r.ret.cluster_queue = r.ret.cluster_queue[len(clusters):]
            r.ret._inflight = True  # type: ignore[attr-defined]
            self.dispatcher.note_dispatch(wid, clusters)
            cycle_load[wid] += cm.batch_cost_us(
                self._cluster_sizes[np.asarray(clusters, np.int64)])
            self._add_ret_group(builders[wid], r, clusters, sn)
        spec_items = self._maybe_spec_retrieval(now)
        if spec_items and self.shard_map is not None:
            # shard mode: a warmup is best effort, and its LocalCache update
            # is a single *replace* (query, top-k, probed set) — splitting
            # it across shards would leave only the last-completing part in
            # the cache.  Dispatch the largest part with a placeable worker
            # and drop the rest: one consistent (emb, top-k, probed) update.
            for r, emb, probes in spec_items:
                parts = sorted(self.shard_map.split(probes),
                               key=lambda sp: (-len(sp[1]), sp[0]))
                for shard, part in parts:
                    wid = self.dispatcher.pick_shard_worker(
                        part, shard, idle, cycle_load, count_routes=False)
                    if wid is not None:
                        builders[wid].add(emb, part, k=SPEC_RET_K,
                                          meta=("spec", r, emb, part))
                        break
        elif spec_items:
            spec_wid = self.dispatcher.least_loaded(idle, extra_load=cycle_load)
            for r, emb, probes in spec_items:
                builders[spec_wid].add(emb, probes, k=SPEC_RET_K,
                                       meta=("spec", r, emb, probes))
        jobs = {}
        for wid in idle:
            if builders[wid].empty and not tasks[wid]:
                continue
            plan = None if builders[wid].empty else builders[wid].build()
            jobs[wid] = self._finalize_ret_job(now, wid, plan, tasks[wid])
        return jobs

    def _fuse_wavefront(self, ordered: list) -> list:
        """In-flight dedup/fusion pass: a *fresh* retrieval stage whose query
        matches an executing leader's (exact byte hash, or cosine >= the
        dedup threshold) subscribes to the leader's result instead of
        assembling its own sub-stages; the rest proceed, with fresh stages
        registered as matchable leaders.  Subscribers are parked in-flight
        and completed by the leader's fan-out."""
        fusion = self.crossreq.fusion
        allow_near = self.cfg.enable_cache_answer
        out = []
        for r in ordered:
            sp = stages.spec_for(r.node)
            if not sp.fusion_fresh(r):  # mid-stage: executing, cannot fuse
                out.append(r)
                continue
            sig = sp.fusion_signature(self, r)
            if sig is None:  # stage kind opts out of fusion
                out.append(r)
                continue
            kind = fusion.try_subscribe(r, sig, allow_near=allow_near)
            if kind is not None:
                sp.park_subscriber(self, r)
                if kind == "exact":
                    self.metrics.dedup_exact += 1
                else:
                    self.metrics.dedup_near += 1
                continue
            fusion.register_leader(r, sig)
            out.append(r)
        return out

    def _assemble_ret_coarse(self, now: float, idle: list[int]) -> dict:
        """Whole-stage jobs: sequential = FIFO-1, async = batch-all-queued.
        Coarse baselines keep the paper's single-retrieval-worker shape: the
        whole batch lands on one (least-loaded) worker."""
        self._ret_fifo = [
            r for r in self._ret_fifo if r in self.active
            and ((r.ret is not None and not r.ret.done)
                 or (r.stage is not None and not r.stage.done))]
        if not self._ret_fifo:
            return {}
        if self.shard_map is not None:
            # shard mode: whole stages still scatter by cluster ownership —
            # a worker cannot scan shards it does not hold.  Requests whose
            # parts could not all be placed (busy owners) keep their
            # leftover clusters queued and stay in the stage FIFO.
            builders: dict[int, PlanBuilder] = {w: PlanBuilder() for w in idle}
            cycle_load: dict[int, float] = {w: 0.0 for w in idle}
            tasks: dict[int, list] = {w: [] for w in idle}
            cm = self.backend.cluster_cost_model
            if self.ft is not None and self.ft.orphan_parts:
                self._place_orphans(builders, cycle_load, idle, now)
            nb = self.ft.not_before if self.ft is not None else None
            keep = []
            for r in self._ret_fifo:
                if nb is not None and nb.get(r.request_id, 0.0) > now:
                    keep.append(r)  # retry backoff still running
                    continue
                if r.stage is not None:
                    # registry stages are placement-free (host arrays hold
                    # the whole index): dispatch the whole unit queue
                    if not r.stage.parked and r.stage.work_queue:
                        stages.spec(r.stage.kind).assemble(
                            self, r, builders, tasks, cycle_load, idle, now,
                            whole_stage=True)
                    continue
                if getattr(r.ret, "_inflight", False):
                    keep.append(r)
                    continue
                self._scatter_ret(builders, cycle_load, r, idle, cm, now,
                                  whole_stage=True)
                if r.ret is not None and r.ret.cluster_queue:
                    keep.append(r)
            self._ret_fifo = keep
            jobs = {}
            for wid in idle:
                if builders[wid].empty and not tasks[wid]:
                    continue
                plan = None if builders[wid].empty else builders[wid].build()
                jobs[wid] = self._finalize_ret_job(now, wid, plan, tasks[wid])
            return jobs
        # both coarse baselines dispatch whole stages, one-shot batched over
        # everything queued; 'sequential' additionally holds the global lock
        take = list(self._ret_fifo)
        self._ret_fifo = []
        if self.ft is not None and self.ft.not_before:
            nb = self.ft.not_before
            self._ret_fifo = [r for r in take
                              if nb.get(r.request_id, 0.0) > now]
            take = [r for r in take if nb.get(r.request_id, 0.0) <= now]
        builder = PlanBuilder()
        wid = self.dispatcher.least_loaded(idle)
        task_list: list = []
        cycle_load = {wid: 0.0}
        for r in take:
            if r.stage is not None:
                if not r.stage.parked and r.stage.work_queue:
                    stages.spec(r.stage.kind).assemble(
                        self, r, {wid: builder}, {wid: task_list}, cycle_load,
                        [wid], now, whole_stage=True)
                continue
            clusters = list(r.ret.cluster_queue)
            r.ret.cluster_queue = []
            r.ret._inflight = True  # type: ignore[attr-defined]
            self.dispatcher.note_dispatch(wid, clusters)
            self._add_ret_group(builder, r, clusters, None)
        if builder.empty and not task_list:
            return {}
        plan = None if builder.empty else builder.build()
        return {wid: self._finalize_ret_job(now, wid, plan, task_list)}

    def _maybe_spec_retrieval(self, now: float):
        """Generation→Retrieval speculation: warm the LocalCache from a
        partial-generation embedding (runs as low-priority ret work)."""
        pol = self.cfg.speculation
        ret_util = self.metrics.ret_busy_us / max(now * self.num_ret_workers, 1.0)
        if not self.spec.throughput_gate(ret_util, 1.0):
            return []
        items = []
        for r in self.active:
            if r.gen is None or r.gen.done or r.gen.speculative_src is not None:
                continue
            node = r.graph.nodes.get(r.current)
            if node is None or not stages.spec_for(node).emits_partial_queries:
                continue
            nxt = r.graph.successor(r.current, r.state)
            nxt_node = r.graph.nodes.get(nxt) if isinstance(nxt, int) else None
            if (nxt_node is None
                    or not stages.spec_for(nxt_node).accepts_probe_warmup):
                continue
            ratio = r.gen.generated / max(r.gen.target_tokens, 1)
            if ratio < pol.spec_ret_ratio or self._spec_ret_round.get(r.request_id, -1) == r.round_idx:
                continue
            self._spec_ret_round[r.request_id] = r.round_idx
            emb = self.backend.partial_embedding(r, r.round_idx, ratio)
            probes = self.index.probe_order(emb[None], max(4, self.cfg.nprobe // 8))[0]
            items.append((r, emb, [int(c) for c in probes[:4]]))
            self.metrics.spec_ret_launches += 1
            if len(items) >= pol.max_spec_per_cycle:
                break
        return items

    def _maybe_spec_generation(self, now: float) -> None:
        """Retrieval→Generation speculation: start the follower generation
        from partial top-k when the gen engine is underutilised."""
        pol = self.cfg.speculation
        gen_load = len([r for r in self.active if r.gen is not None and not r.gen.done])
        if not self.spec.throughput_gate(gen_load / self.cfg.max_gen_batch, 1.0):
            return
        cands = []
        for r in self.active:
            if r.ret is None or r.ret.done or r.gen is not None:
                continue
            nxt = r.graph.successor(r.current, r.state)
            nxt_node = r.graph.nodes.get(nxt) if isinstance(nxt, int) else None
            if (nxt_node is None
                    or not stages.spec_for(nxt_node).supports_spec_start):
                continue
            total = len(r.ret.searched) + len(r.ret.cluster_queue)
            d0 = float(np.sqrt(max(
                self.index.centroid_dists(r.ret.query_vec[None])[0].min(), 1e-12)))
            if self.spec.spec_gen_ready(len(r.ret.searched), total,
                                        float(np.sqrt(max(r.ret.topk.kth, 0.0)))
                                        if np.isfinite(r.ret.topk.kth) else np.inf,
                                        d0):
                cands.append((r.ret.topk.kth, r, nxt))
        for _, r, nxt in self.spec.rank_spec_gen(cands)[: pol.max_spec_per_cycle]:
            node = r.graph.nodes[nxt]
            tgt = self.workload.gen_tokens(r.request_id, node.node_id, node.max_tokens)
            basis = self.dag.new_subnode(r, "ret", {"clusters": list(r.ret.searched)})
            self.dag.complete(basis)
            transforms.add_speculative_generation(self.dag, r, basis, node, tgt,
                                                  self.budget)
            r.gen.started_at = now

    def _mitigate_straggler(self, dur: float, expected: float,
                            worker_id: int = -1) -> float:
        raw = self.backend.maybe_straggle(dur, worker_id=worker_id)
        if raw > self.cfg.straggler_cap * expected and self.cfg.straggler_redispatch:
            self.metrics.straggler_redispatches += 1
            return self.cfg.straggler_cap * expected + self.cfg.sched_overhead_us
        return raw

    # ------------------------------------------------------- fault recovery
    def _ft_register_job(self, job, wid: int, hedge_tokens=None) -> None:
        """Token-register every recoverable unit of a freshly dispatched job
        and draw each dispatch's transient-failure fate from the seeded
        stream.  Tokens give hedged twins and fenced late results
        exactly-once application; speculative warmups are best-effort and
        carry no token."""
        ft = self.ft
        tokens: dict = {}
        failed: set = set()
        plan = job["plan"]
        if plan is not None:
            for g, meta in enumerate(plan.group_meta):
                if meta[0] not in ("ret", "shard", "stage"):
                    continue
                if hedge_tokens is not None and g in hedge_tokens:
                    tok = hedge_tokens[g]
                    unit = ft.units.get(tok)
                    if unit is None:
                        # twin settled between selection and dispatch: keep
                        # a resolved token so this copy's result is fenced
                        ft.units[tok] = {"meta": meta, "inflight": 1,
                                         "resolved": True}
                    else:
                        unit["inflight"] += 1
                else:
                    tok = ft.next_token
                    ft.next_token += 1
                    ft.units[tok] = {"meta": meta, "inflight": 1,
                                     "resolved": False}
                tokens[g] = tok
                seq = ft.dispatch_seq
                ft.dispatch_seq += 1
                if ft.plan is not None and ft.plan.transient_fault(wid, seq):
                    failed.add(("g", g))
        task_tokens: dict = {}
        for i, (task, _fn) in enumerate(job["tasks"]):
            tok = ft.next_token
            ft.next_token += 1
            ft.units[tok] = {"task": task, "inflight": 1, "resolved": False}
            task_tokens[i] = tok
            seq = ft.dispatch_seq
            ft.dispatch_seq += 1
            if ft.plan is not None and ft.plan.transient_fault(wid, seq):
                failed.add(("t", i))
        job["tokens"] = tokens
        job["task_tokens"] = task_tokens
        job["failed"] = failed

    def _ft_tick(self, now: float) -> None:
        """Per-cycle fault housekeeping: fold heartbeat state into lifecycle
        transitions (recovering a dead worker's lost units), expire retry
        backoffs, mark jobs past their cost-model deadline, and hedge
        in-flight work of timed-out or SUSPECT workers."""
        ft = self.ft
        for wid, old, new in self.lifecycle.tick(now, ft.plan):
            if self.obs is not None:
                self.obs.worker_transition(wid, old, new, now)
            if new == lifecycle_mod.SUSPECT:
                self.metrics.worker_suspects += 1
            elif new == lifecycle_mod.DEAD:
                self.metrics.worker_deaths += 1
                self._on_worker_dead(wid, now)
        if ft.not_before:
            for rid in [r for r, t in ft.not_before.items() if t <= now]:
                del ft.not_before[rid]
        for wid, job in enumerate(self._ret_jobs):
            if job is None or job.get("lost"):
                continue
            if (not job.get("timed_out")
                    and job.get("deadline") is not None
                    and job["deadline"] <= now < job["end"]):
                job["timed_out"] = True
                self.metrics.task_timeouts += 1
            if (self.cfg.hedge_suspect and not job.get("hedge")
                    and not job.get("hedged")
                    and (job.get("timed_out")
                         or self.lifecycle.state_of(wid)
                         == lifecycle_mod.SUSPECT)):
                hedged_units = self._hedge_job(wid, job, now)
                if hedged_units:
                    job["hedged"] = True
                    self.metrics.hedged_dispatches += hedged_units

    def _job_crashed(self, wid: int, job) -> bool:
        """True when the fault plan kills the worker before this job's
        completion instant — its results are lost and must be fenced."""
        plan = self.ft.plan
        if plan is None:
            return False
        c = plan.crash_at(wid)
        return c is not None and c < job["end"]

    def _on_worker_dead(self, wid: int, now: float) -> None:
        """Recover everything in flight on a worker just declared DEAD: the
        job's results are fenced and every lost unit re-dispatched (the
        sub-stage is the re-dispatch quantum).  Crash recovery does not
        consume the transient retry budget — a worker dies at most once."""
        ft = self.ft
        job = self._ret_jobs[wid]
        if job is None:
            return
        self._ret_jobs[wid] = None
        toks = list(job.get("tokens", {}).values())
        toks += list(job.get("task_tokens", {}).values())
        for tok in toks:
            unit = ft.units.get(tok)
            if unit is None:
                continue
            unit["inflight"] -= 1
            if unit["resolved"]:
                if unit["inflight"] <= 0:
                    del ft.units[tok]
                continue
            if unit["inflight"] > 0:
                continue  # a hedge twin still runs this unit
            del ft.units[tok]
            self.metrics.redispatches += 1
            if self.obs is not None:
                self.obs.open_gap(self._unit_req(unit), now, "fault_recovery")
            self._ft_requeue_unit(unit, now)

    def _ft_settle_group(self, job, g: int, now: float) -> bool:
        """First-result-wins settlement of one completed plan group.
        Returns True when the result should be applied (this copy won and
        did not fail transiently)."""
        ft = self.ft
        tok = job["tokens"].get(g)
        if tok is None:
            return True  # spec warmup: no recovery semantics
        unit = ft.units.get(tok)
        if unit is None:
            return False  # fully settled already: fence the late copy
        unit["inflight"] -= 1
        if unit["resolved"]:
            if unit["inflight"] <= 0:
                del ft.units[tok]
            return False
        if ("g", g) in job["failed"]:
            self.metrics.transient_failures += 1
            if unit["inflight"] <= 0:
                del ft.units[tok]
                self._ft_retry_or_degrade(unit, now)
            return False
        unit["resolved"] = True
        if unit["inflight"] <= 0:
            del ft.units[tok]
        if job.get("hedge"):
            self.metrics.hedged_wins += 1
        return True

    def _ft_settle_task(self, job, i: int, now: float) -> bool:
        """Task-batch analogue of ``_ft_settle_group``."""
        ft = self.ft
        tok = job["task_tokens"].get(i)
        if tok is None:
            return True
        unit = ft.units.get(tok)
        if unit is None:
            return False
        unit["inflight"] -= 1
        if unit["resolved"]:
            if unit["inflight"] <= 0:
                del ft.units[tok]
            return False
        if ("t", i) in job["failed"]:
            self.metrics.transient_failures += 1
            if unit["inflight"] <= 0:
                del ft.units[tok]
                self._ft_retry_or_degrade(unit, now)
            return False
        unit["resolved"] = True
        if unit["inflight"] <= 0:
            del ft.units[tok]
        return True

    @staticmethod
    def _unit_req(unit):
        meta = unit.get("meta")
        if meta is not None:
            return meta[1].req if meta[0] == "shard" else meta[1]
        return unit["task"].req

    def _ft_retry_or_degrade(self, unit, now: float) -> None:
        """A unit failed transiently: re-dispatch with exponential backoff
        while the per-(request, node) budget lasts, then complete the stage
        degraded."""
        ft = self.ft
        r = self._unit_req(unit)
        if r is None or r.finished:
            return
        key = (r.request_id, r.current)
        att = ft.attempts.get(key, 0) + 1
        ft.attempts[key] = att
        if att > self.cfg.retry_budget:
            self.metrics.degraded_drops += 1
            self._ft_degrade_unit(unit, now)
            return
        self.metrics.retries += 1
        if self.obs is not None:
            self.obs.open_gap(r, now, "retry_hedge_failover")
        back = self.cfg.retry_backoff_us * (2.0 ** (att - 1))
        ft.not_before[r.request_id] = max(
            ft.not_before.get(r.request_id, 0.0), now + back)
        self._ft_requeue_unit(unit, now)

    def _ft_requeue_unit(self, unit, now: float) -> None:
        """Put a lost/failed unit back at the head of its owner's queue; the
        next assembly cycle re-dispatches it, possibly on another worker."""
        meta = unit.get("meta")
        if meta is None:
            task = unit["task"]
            r = task.req
            if task.sn is not None:
                self.dag.complete(task.sn)
            prog = r.stage
            if r.finished or prog is None or prog.kind != task.kind:
                return
            prog.work_queue[0:0] = list(task.units)
            prog.inflight_units -= len(task.units)
            self._requeue_coarse(r)
            return
        kind = meta[0]
        if kind == "ret":
            _, r, sn, clusters = meta
            if sn is not None:
                self.dag.complete(sn)
            if r.finished or r.ret is None:
                return
            r.ret.cluster_queue = list(clusters) + r.ret.cluster_queue
            r.ret._inflight = False  # type: ignore[attr-defined]
            self._requeue_coarse(r)
        elif kind == "shard":
            _, gather, positions = meta
            self.ft.orphan_parts.append((gather, positions))
        else:  # "stage": one registry plan group (e.g. a rewrite variant)
            _, r, sp, ref = meta
            vi, sid = ref
            prog = r.stage
            if r.finished or prog is None or prog.kind != sp.kind:
                return
            pl = prog.payload
            pending = pl["sn_pending"].get(sid)
            if pending is not None:
                pending[1] -= 1
                if pending[1] <= 0:
                    self.dag.complete(pending[0])
                    del pl["sn_pending"][sid]
            prog.work_queue.insert(0, vi)
            prog.inflight_units -= 1
            self._requeue_coarse(r)

    def _ft_degrade_unit(self, unit, now: float) -> None:
        """Retry budget exhausted (or nothing can ever run the unit): drop
        the work and complete the stage with whatever partial results exist,
        flagged degraded — the contract is partial top-k, never a hang."""
        meta = unit.get("meta")
        if meta is None:
            task = unit["task"]
            r = task.req
            if task.sn is not None:
                self.dag.complete(task.sn)
            prog = r.stage
            if r.finished or prog is None or prog.kind != task.kind:
                return
            prog.inflight_units -= len(task.units)
            self._flag_degraded(r, now)
            if prog.done:
                self._finish_stage(r, now)
            else:
                self._requeue_coarse(r)
            return
        kind = meta[0]
        if kind == "ret":
            _, r, sn, clusters = meta
            if sn is not None:
                self.dag.complete(sn)
            if r.finished or r.ret is None:
                return
            r.ret._inflight = False  # type: ignore[attr-defined]
            self._flag_degraded(r, now)
            if r.ret.done:
                self._finish_ret_stage(r, now)
            else:
                self._requeue_coarse(r)
        elif kind == "shard":
            _, gather, positions = meta
            gather.remaining -= 1
            r = gather.req
            if not r.finished and r.ret is not None:
                self._flag_degraded(r, now)
            if gather.remaining <= 0:
                self._finish_gather(gather, now)
        else:
            _, r, sp, ref = meta
            vi, sid = ref
            prog = r.stage
            if r.finished or prog is None or prog.kind != sp.kind:
                return
            pl = prog.payload
            pending = pl["sn_pending"].get(sid)
            if pending is not None:
                pending[1] -= 1
                if pending[1] <= 0:
                    self.dag.complete(pending[0])
                    del pl["sn_pending"][sid]
            prog.inflight_units -= 1
            self._flag_degraded(r, now)
            if prog.done:
                self._finish_stage(r, now)
            else:
                self._requeue_coarse(r)

    def _requeue_coarse(self, r: RequestContext) -> None:
        if (self.cfg.mode != "hedra" and r in self.active
                and r not in self._ret_fifo):
            self._ret_fifo.append(r)

    def _flag_degraded(self, r: RequestContext, now: float) -> None:
        if self.obs is not None and not r.state.get("_degraded"):
            self.obs.degraded(r, now)
        r.state["_degraded"] = True
        r.log(now, "degraded", r.current)

    def _degrade_stranded(self, now: float) -> None:
        """No worker can take retrieval-side work (all DEAD or DRAINING, or
        nothing eligible is ever coming back): complete every queued
        retrieval/stage unit degraded instead of hanging.  Generation work
        is unaffected (separate worker)."""
        if self.ft is not None and self.ft.orphan_parts:
            parts = self.ft.orphan_parts
            self.ft.orphan_parts = []
            for gather, positions in parts:
                self.metrics.degraded_drops += 1
                gather.remaining -= 1
                r = gather.req
                if r.finished or r.ret is None:
                    continue
                self._flag_degraded(r, now)
                if gather.remaining <= 0:
                    self._finish_gather(gather, now)
        for r in list(self.active):
            if r.finished:
                continue
            if (r.ret is not None and not r.ret.done
                    and not getattr(r.ret, "_inflight", False)):
                self.metrics.degraded_drops += 1
                r.ret.cluster_queue = []
                self._flag_degraded(r, now)
                self._finish_ret_stage(r, now)
            elif (r.stage is not None and not r.stage.done
                  and not r.stage.parked and r.stage.work_queue
                  and r.stage.inflight_units == 0):
                self.metrics.degraded_drops += 1
                r.stage.work_queue = []
                self._flag_degraded(r, now)
                self._finish_stage(r, now)

    def _hedge_job(self, wid: int, job, now: float) -> int:
        """Duplicate a straggling job's unresolved retrieval groups onto an
        idle HEALTHY worker (first result wins via the unit tokens).  Host
        StageTasks are not hedged — their work re-dispatches on death.
        Returns the number of duplicated units (0 = nothing hedged)."""
        plan = job["plan"]
        if plan is None or not job.get("tokens"):
            return 0
        cand = [w for w in range(self.num_ret_workers)
                if w != wid and self._ret_jobs[w] is None
                and self.lifecycle.can_schedule(w)]
        if not cand:
            return 0
        ft = self.ft
        builder = PlanBuilder()
        tokens: dict = {}
        g_new = 0
        for g, meta in enumerate(plan.group_meta):
            tok = job["tokens"].get(g)
            unit = ft.units.get(tok) if tok is not None else None
            if unit is None or unit["resolved"] or unit["inflight"] != 1:
                continue
            if meta[0] == "ret":
                _, r, sn, clusters = meta
                if r.finished or r.ret is None:
                    continue
                builder.add(r.ret.query_vec, clusters,
                            k=int(plan.group_k[g]), meta=meta,
                            seed=r.ret.topk, last_kth=r.ret.last_kth,
                            no_improve=r.ret.no_improve)
            elif meta[0] == "shard":
                _, gather, positions = meta
                r = gather.req
                if r.finished or r.ret is None:
                    continue
                part = [gather.clusters[int(i)] for i in positions]
                builder.add(r.ret.query_vec, part,
                            k=int(plan.group_k[g]), meta=meta,
                            out_k=gather.board.k)
            else:
                continue  # stage variant scans: recovered on death instead
            tokens[g_new] = tok
            g_new += 1
        if builder.empty:
            return 0
        wid2 = self.dispatcher.least_loaded(cand)
        hjob = self._finalize_ret_job(now, wid2, builder.build(),
                                      hedge_tokens=tokens)
        hjob["hedge"] = True
        self._ret_jobs[wid2] = hjob
        if self.obs is not None:
            self.obs.hedge_link(job, hjob, now)
        return g_new

    def _pick_failover_worker(self, part, idle, cycle_load):
        """Where an orphaned shard part can run now that its owner is DEAD
        or DRAINING: a crossreq replica holder whose slab covers the whole
        part, else (failover_whole_index) any serving worker modelling a
        shared-storage whole-index scan.  Returns ``(wid, can_wait)`` — wid
        None with can_wait True means eligible workers exist but are busy
        (keep the part queued); None/False means nothing can ever cover it
        (complete degraded)."""
        eligible = set()
        if self.crossreq is not None and self.crossreq.replicas is not None:
            for w in self.crossreq.replicas.covering_holders(part):
                if self.lifecycle.serving(w):
                    eligible.add(int(w))
        if self.cfg.failover_whole_index:
            for w in range(self.num_ret_workers):
                if self.lifecycle.serving(w):
                    eligible.add(w)
        if not eligible:
            return None, False
        ready = [w for w in idle if w in eligible]
        if not ready:
            return None, True
        return self.dispatcher.least_loaded(ready, extra_load=cycle_load), True

    def _place_orphans(self, builders, cycle_load, idle, now) -> None:
        """Re-dispatch shard scatter parts lost on dead workers: the owner
        first (if it serves again), then replica holders, then whole-index
        failover; parts nothing covers complete their request degraded."""
        ft = self.ft
        cm = self.backend.cluster_cost_model
        keep = []
        for gather, positions in ft.orphan_parts:
            r = gather.req
            if r.finished or r.ret is None:
                gather.remaining -= 1
                continue
            if ft.not_before.get(r.request_id, 0.0) > now:
                keep.append((gather, positions))
                continue
            part = [gather.clusters[int(i)] for i in positions]
            shard = int(self.shard_map.owner[part[0]])
            if self.lifecycle.owner_serves(shard):
                wid = self.dispatcher.pick_shard_worker(
                    part, shard, idle, extra_load=cycle_load)
                can_wait = True
            else:
                wid, can_wait = self._pick_failover_worker(part, idle,
                                                           cycle_load)
            if wid is None:
                if can_wait:
                    keep.append((gather, positions))
                else:
                    self.metrics.degraded_drops += 1
                    self._flag_degraded(r, now)
                    gather.remaining -= 1
                    if gather.remaining <= 0:
                        self._finish_gather(gather, now)
                continue
            builders[wid].add(r.ret.query_vec, part, k=r.ret.topk.k,
                              meta=("shard", gather, positions),
                              out_k=gather.board.k)
            self.dispatcher.note_dispatch(wid, part)
            cycle_load[wid] = cycle_load.get(wid, 0.0) + cm.batch_cost_us(
                self._cluster_sizes[np.asarray(part, np.int64)])
            self.metrics.shard_parts += 1
            if wid != shard:
                self.metrics.failovers += 1
                if self.obs is not None:
                    self.obs.failover(r, wid, now)
        ft.orphan_parts = keep

    # ------------------------------------------------------------ main loop
    def _cycle(self, *, horizon: Optional[float] = None,
               hard_cutoff: Optional[float] = None) -> str:
        """One scheduling cycle: admit arrivals due at ``self.now``, make
        speculation decisions, assemble work for idle workers, then advance
        the event clock to the next completion/arrival and process it.

        Returns:
          ``"advanced"``  the clock moved (or instant progress was made);
                          call again.
          ``"done"``      nothing pending, in flight, or active.
          ``"horizon"``   the next event lies beyond ``horizon``; the clock
                          did not move and in-flight jobs stay in flight
                          (streaming ``step()`` stop condition).
          ``"cutoff"``    the clock moved past ``hard_cutoff`` (legacy
                          ``run(max_time_us)`` stop condition; completions at
                          that instant are *not* processed, matching the
                          pre-streaming batch loop exactly).
        """
        now = self.now
        nw = self.num_ret_workers
        if self.telemetry is not None:
            self.telemetry.maybe_sample(self, now)
        if self.ft is not None:
            self._ft_tick(now)
        if (not self.lifecycle.all_healthy()
                and self.lifecycle.alive_for_work() == 0):
            # nobody left to take retrieval-side work: complete it degraded
            # instead of hanging (generation has its own worker)
            self._degrade_stranded(now)
        # admit arrivals (probe orders batched across the whole cycle)
        admitted = []
        while self._pending and self._pending[0][0] <= now:
            key_t, seq, req = heapq.heappop(self._pending)
            if req.arrival_us != key_t:
                # the request was re-dated after queuing (e.g. journal
                # recovery deferring re-admission); lazily re-key with the
                # live arrival instead of admitting at the stale stamp
                heapq.heappush(self._pending,
                               (float(req.arrival_us), seq, req))
                continue
            self.active.append(req)
            admitted.append(req)
        if admitted:
            self._prime_probe_orders(admitted, now)
            for req in admitted:
                self._enter_stage(req, now)
        # speculation decisions on the current wavefront
        if self.cfg.speculation.enabled:
            self._maybe_spec_generation(now)
        # dispatch to idle workers
        ret_inflight = any(j is not None for j in self._ret_jobs)
        sequential_lock = (self.cfg.mode == "sequential" and
                           (self._gen_job is not None or ret_inflight))
        if self._gen_job is None and not sequential_lock:
            self._gen_job = self._assemble_gen(now)
            if self._gen_job is not None:
                if self.obs is not None:
                    self.obs.gen_job(self._gen_job, now)
                if self.telemetry is not None:
                    self.telemetry.on_gen_job(self._gen_job)
        sequential_lock = (self.cfg.mode == "sequential" and
                           (self._gen_job is not None or ret_inflight))
        if self.lifecycle.all_healthy():
            idle = [w for w in range(nw) if self._ret_jobs[w] is None]
        else:
            idle = [w for w in range(nw) if self._ret_jobs[w] is None
                    and self.lifecycle.can_schedule(w)]
        if idle and not sequential_lock:
            for wid, job in self._assemble_ret(now, idle).items():
                self._ret_jobs[wid] = job
        # advance virtual time
        events = []
        if self._gen_job:
            events.append(self._gen_job["end"])
        events.extend(j["end"] for j in self._ret_jobs
                      if j is not None and not j.get("lost"))
        if self._pending:
            events.append(self._pending[0][0])
        if self.ft is not None:
            # fault-driven wakeups: lifecycle state changes (crash/stall
            # detection instants), per-job deadlines, retry-backoff expiry
            t = self.lifecycle.next_transition_us(now, self.ft.plan)
            if t is not None:
                events.append(t)
            for j in self._ret_jobs:
                if j is None or j.get("lost") or j.get("timed_out"):
                    continue
                d = j.get("deadline")
                if d is not None and now < d < j["end"]:
                    events.append(d)
            events.extend(t for t in self.ft.not_before.values() if t > now)
        if not events:
            if self.active:
                # no work assembled but requests active -> enter stages
                for r in list(self.active):
                    self._enter_stage(r, now)
                self._idle_cycles += 1
                if (self._idle_cycles > 2
                        and (self.ft is not None
                             or not self.lifecycle.all_healthy())):
                    # retrieval work exists but nothing can ever schedule
                    # it (e.g. sole eligible worker gone): degrade it
                    self._degrade_stranded(now)
                if not self.active or any(r.gen or r.ret or r.stage
                                          for r in self.active):
                    return "advanced"
                raise RuntimeError(
                    f"deadlock: {len(self.active)} active requests, no work")
            return "done"
        self._idle_cycles = 0
        nxt = min(events)
        if horizon is not None and nxt > horizon:
            return "horizon"
        self.now = now = nxt
        if hard_cutoff is not None and now > hard_cutoff:
            return "cutoff"
        # completions
        if self._gen_job and self._gen_job["end"] <= now:
            self.metrics.gen_busy_us += self._gen_job["dur"]
            self._complete_gen(self._gen_job, now)
            self._gen_job = None
        for wid in range(nw):
            job = self._ret_jobs[wid]
            if job is None or job.get("lost") or job["end"] > now:
                continue
            if self.ft is not None and self._job_crashed(wid, job):
                # the worker died mid-job: fence its results; the lost
                # units are recovered when missed heartbeats declare it
                # DEAD (lifecycle transition instants are in the events)
                job["lost"] = True
                if self.obs is not None:
                    self.obs.ret_job_lost(job, now)
                continue
            # the dispatcher is the single policy-side load source;
            # Metrics mirrors its completed share instead of
            # double-booking an accumulator of its own
            self.dispatcher.note_complete(wid, job["dur"])
            self.metrics.ret_busy_per_worker[wid] = (
                self.dispatcher.workers[wid].completed_us)
            self._complete_ret(job, now)
            self._ret_jobs[wid] = None
        return "advanced"

    @handoff("server")
    def run(self, max_time_us: float = 4e9) -> Metrics:
        """Run to completion (or the time cutoff) from the current clock.
        On a fresh scheduler with every request pre-loaded this is the
        legacy batch loop, event for event; after streaming ``step()`` /
        mid-run submissions it drains whatever remains."""
        guard = 0
        while True:
            guard += 1
            if guard > 5_000_000:
                raise RuntimeError("scheduler stuck — no progress")
            status = self._cycle(hard_cutoff=max_time_us)
            if status in ("done", "cutoff"):
                break
        return self._finalize_metrics()

    @handoff("server")
    def step(self, until_us: float) -> Metrics:
        """Incremental streaming core: advance the event clock to
        ``until_us``, processing every completion/arrival due by then, and
        return with any later-ending jobs still in flight.  Mid-run
        submissions (``add_request`` with ``arrival_us >= self.now``) between
        ``step()`` calls interleave exactly as if they had been pre-loaded."""
        until = float(until_us)
        if until <= self.now:
            # the clock is already at (or past) the horizon: defer
            # admission+assembly to the next cycle, so several submissions
            # stamped with the *same* arrival time — step(t); submit(a, t);
            # step(t); submit(b, t) — are admitted together there, exactly
            # as the batch path admits equal arrivals in one cycle
            self.metrics.sim_time_us = self.now
            return self.metrics
        guard = 0
        while True:
            guard += 1
            if guard > 5_000_000:
                raise RuntimeError("scheduler stuck — no progress")
            status = self._cycle(horizon=until)
            if status != "advanced":
                break
            if self.now >= until:
                # the clock just reached the horizon: stop *before* the next
                # cycle's admission+assembly phase, so a submission stamped
                # exactly ``until`` (including one coinciding with the
                # completion we just processed) still joins that assembly —
                # the batch loop admits arrivals ahead of assembly within
                # the same cycle, and fingerprint identity requires the
                # streaming path to preserve that ordering at exact ties
                break
        if until > self.now:
            self.now = until
        self.metrics.sim_time_us = self.now
        return self.metrics

    @handoff("server")
    def drain(self, max_time_us: float = 4e9) -> Metrics:
        """Finish all admitted/in-flight work (streaming shutdown)."""
        return self.run(max_time_us=max_time_us)

    def _finalize_metrics(self) -> Metrics:
        self.metrics.sim_time_us = self.now
        if self.telemetry is not None:
            self.telemetry.finalize(self, self.now)
        hyb = getattr(self.backend, "hybrid", None)
        if hyb is not None:
            self.metrics.cache_stats = hyb.stats()
        self.metrics.replica_routes = self.dispatcher.replica_routes
        self.metrics.dedup_saved_us = float(
            getattr(self.backend, "fused_saved_us", 0.0))
        return self.metrics

    # ----------------------------------------------------------- completion
    def _complete_gen(self, job, now: float) -> None:
        for r in job["reqs"]:
            # rolled back mid-flight: gen was replaced by a fresh progress
            if r.gen is None or r.gen.engine_seq != "inflight":
                continue
            r.gen.engine_seq = None
            if not r.gen.prefilled:
                r.gen.prefilled = True
            r.gen.generated = min(r.gen.generated + job["n_steps"],
                                  r.gen.target_tokens)
            if r.gen.done:
                if r.gen.speculative_src is not None:
                    continue  # wait for retrieval validation
                node = r.graph.nodes.get(r.current)
                if (node is not None
                        and stages.spec_for(node).resource == stages.GEN):
                    self._finish_gen_stage(r, now)

    def _complete_ret(self, job, now: float) -> None:
        plan = job["plan"]
        if plan is not None:
            results = job["results_fn"]()  # item-level BatchTopK scoreboard
            # one vectorized fold: per-group merged top-k + improvement
            # streaks.  Shard-mode partials only need the raw item rows (the
            # gather plan folds them once, at merge time), so an all-shard
            # job skips the fold
            res = (plan.finalize(results)
                   if any(m[0] != "shard" for m in plan.group_meta) else None)
            for g, meta in enumerate(plan.group_meta):
                kind = meta[0]
                kg = int(plan.group_k[g])
                if (self.ft is not None
                        and not self._ft_settle_group(job, g, now)):
                    continue  # fenced duplicate, hedged loser, or retrying
                if kind == "ret":
                    _, r, sn, clusters = meta
                    self._apply_ret_result(r, res, g, kg, plan.k, clusters,
                                           sn, now)
                elif kind == "shard":
                    # one per-shard partial scan: scatter its item rows into
                    # the gather board (original probe order); the last part
                    # to land triggers the k-way merge
                    _, gather, positions = meta
                    gather_scatter_rows(
                        gather.board, positions, results,
                        int(plan.group_start[g]), int(plan.group_start[g + 1]))
                    gather.remaining -= 1
                    if gather.remaining == 0:
                        self._finish_gather(gather, now)
                elif kind == "stage":
                    # plan group owned by a registry stage (e.g. one rewrite
                    # query-variant scan): hand the folded rows to its spec
                    _, r, sp, ref = meta
                    sp.complete_plan_group(self, r, ref, res, g, kg, now)
                else:  # speculative warmup: results land in the LocalCache
                    _, r, emb, probed = meta
                    if r.sim_cache is None:
                        r.sim_cache = LocalCache()
                    r.sim_cache.update(emb, res.group_topk(g, kg), self.index,
                                       probed)
                    self.spec.stats.attempted_ret += 1
        for i, (task, fn) in enumerate(job.get("tasks", ())):
            if (self.ft is not None
                    and not self._ft_settle_task(job, i, now)):
                continue
            stages.spec(task.kind).complete_task(self, task, fn(), now)

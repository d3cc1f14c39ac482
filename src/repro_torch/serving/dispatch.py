"""SLO- and skew-aware dispatch of retrieval sub-stages to a worker pool.

The paper's inter-request skewness observation (§4.4, Fig. 8) says a small
set of IVF clusters absorbs most probes.  When the host side runs more than
one retrieval worker, that skew becomes a placement problem: routing a hot
cluster to the worker that served it recently keeps per-worker working sets
small (cache/NUMA locality in the real engine; preserved same-cluster query
batching in the simulated one), while cold clusters should simply go to
whoever is least loaded.  Orthogonally, per-request SLOs (RAGO-style
schedule search) need near-deadline requests admitted to sub-stage assembly
first, which is a pure ordering concern.

This module keeps both concerns out of the scheduler loop:

* ``RetrievalDispatcher`` — per-worker EMA cluster-affinity history plus
  accumulated busy time; ``pick_worker`` implements the policies
  ``affinity`` (history coverage, least-loaded fallback), ``least_loaded``
  and ``round_robin``.  The dispatcher is the single policy-side source of
  worker load: ``note_busy`` accumulates dispatched (in-flight) time and
  ``note_complete`` the completed share — ``Metrics.ret_busy_per_worker``
  mirrors the latter instead of double-booking its own accumulator.
* Cross-request extensions (``repro_torch.crossreq``): an attached shared
  ``PopularityTracker`` receives every dispatched cluster (the global probe
  histogram superseding the per-worker EMA as the skew source of truth),
  and an attached ``ReplicaMap`` routes sub-stages touching replicated hot
  clusters to the least-loaded replica holder instead of serialising them
  on a single affinity owner.
* ``order_by_slack`` — sorts a wavefront by SLO slack
  ``deadline - now - estimated_remaining`` so the tightest requests are
  assembled (and therefore dispatched) first.
* ``AdmissionController`` — streaming admission control: a bounded pending
  queue plus deadline-infeasibility load shedding.  A request is shed when
  its remaining SLO slack cannot cover a cost-model lower bound of one pass
  over its graph — admitting it could only burn worker time on a guaranteed
  SLO violation and push *other* requests past their deadlines.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.ownership import owned_by

DISPATCH_POLICIES = ("affinity", "least_loaded", "round_robin")


@dataclasses.dataclass
class WorkerState:
    wid: int
    freq: np.ndarray  # per-cluster EMA of recently dispatched clusters
    # single policy-side load source: busy_us accumulates at dispatch time
    # (includes in-flight work, what load-aware placement needs) and
    # completed_us at completion time (what Metrics.ret_busy_per_worker
    # mirrors for occupancy reporting)
    busy_us: float = 0.0
    completed_us: float = 0.0
    dispatches: int = 0


@owned_by("scheduler")
class RetrievalDispatcher:
    """Assigns retrieval sub-stages (cluster lists) to a pool of workers."""

    def __init__(self, num_workers: int, n_clusters: int, *,
                 policy: str = "affinity", decay: float = 0.95,
                 tracker=None, replica_map=None, shard_map=None):
        if policy not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch policy {policy!r}; choose from {DISPATCH_POLICIES}")
        self.num_workers = max(1, int(num_workers))
        self.policy = policy
        self.decay = decay
        # optional crossreq state: the shared cluster-popularity histogram
        # (fed on every dispatch) and the hot-cluster replica map consulted
        # ahead of the configured policy
        self.tracker = tracker
        self.replica_map = replica_map
        self.replica_routes = 0
        # shard-mode ownership table (retrieval.distributed.ShardMap): set
        # when the serving path runs distributed IVF retrieval — placement
        # becomes ownership-constrained (pick_shard_worker) instead of
        # policy-driven
        self.shard_map = shard_map
        self.n_clusters = int(n_clusters)
        self.workers = [
            WorkerState(w, np.zeros(n_clusters, np.float64))
            for w in range(self.num_workers)
        ]
        self._rr = 0

    def add_worker(self) -> int:
        """Grow the pool by one worker (mid-run registration)."""
        wid = self.num_workers
        self.workers.append(
            WorkerState(wid, np.zeros(self.n_clusters, np.float64)))
        self.num_workers += 1
        return wid

    # ---------------------------------------------------------------- choice
    def least_loaded(self, candidates: Sequence[int],
                     extra_load: Optional[dict] = None) -> int:
        """Lowest accumulated busy time.  ``extra_load`` carries load already
        assigned *during the current assembly cycle* (before any note_busy)
        so that several sub-stages assembled at the same instant spread
        across the pool instead of piling onto one worker."""
        extra = extra_load or {}

        def load(w: int) -> float:
            return self.workers[w].busy_us + extra.get(w, 0.0)

        return min(candidates, key=lambda w: (load(w), w))

    def pick_worker(self, clusters: Iterable[int], candidates: Sequence[int],
                    extra_load: Optional[dict] = None) -> int:
        """Choose a worker among ``candidates`` (idle worker ids) for a
        sub-stage touching ``clusters``."""
        if not candidates:
            raise ValueError("no candidate workers")
        if len(candidates) == 1:
            return candidates[0]
        if self.policy == "round_robin":
            w = candidates[self._rr % len(candidates)]
            self._rr += 1
            return w
        if self.policy == "least_loaded":
            return self.least_loaded(candidates, extra_load)
        aff = self._affinity_pick(clusters, candidates, extra_load)
        if self.replica_map is not None:
            # replica-aware routing (affinity only — the other policies do
            # not serialise hot clusters): a sub-stage touching replicated
            # hot clusters may land on any idle replica holder, least-loaded
            # among them, instead of the single affinity owner.  Counted
            # only when the choice actually deviates from affinity's.
            holders = self.replica_map.owners_for(clusters)
            cands = [w for w in candidates if w in holders]
            if cands:
                pick = self.least_loaded(cands, extra_load)
                if pick != aff:
                    self.replica_routes += 1
                return pick
        return aff

    def pick_shard_worker(self, clusters: Sequence[int], owner: int,
                          candidates: Sequence[int],
                          extra_load: Optional[dict] = None,
                          count_routes: bool = True) -> Optional[int]:
        """Placement for one shard-mode partial scan: the part's clusters all
        belong to shard ``owner``, so the owning worker is the default
        target.  Hot clusters replicated onto other workers' device slabs
        (crossreq ``ReplicaMap``) widen the choice: a worker holding a
        visible replica of *every* cluster in the part can serve it too, and
        the least-loaded eligible holder wins (counted in
        ``replica_routes`` when the choice deviates from the owner;
        best-effort placements like speculative warmups pass
        ``count_routes=False`` so throwaway parts don't inflate the
        metric).  Returns ``None`` when neither the owner nor any
        full-coverage replica holder is among ``candidates`` (idle
        workers) — the part stays queued for a later cycle."""
        cands = [owner] if owner in candidates else []
        if self.replica_map is not None and clusters:
            common: Optional[set] = None
            for c in clusters:
                held = self.replica_map.owners(int(c))
                cover = set(held) if held else set()
                common = cover if common is None else (common & cover)
                if not common:
                    break
            if common:
                cands += [w for w in sorted(common)
                          if w in candidates and w != owner]
        if not cands:
            return None
        pick = self.least_loaded(cands, extra_load)
        if pick != owner and count_routes:
            self.replica_routes += 1
        return pick

    def _affinity_pick(self, clusters: Iterable[int],
                       candidates: Sequence[int],
                       extra_load: Optional[dict]) -> int:
        """Worker whose recent history best covers these clusters; cold
        clusters (no history anywhere) fall back to least-loaded."""
        extra = extra_load or {}
        cl = np.asarray(list(clusters), np.int64)
        scores = {w: float(self.workers[w].freq[cl].sum()) for w in candidates}
        # explicit -w tie-break: equal (coverage, load) must resolve to the
        # lowest worker id on every run, whatever order candidates arrive in
        best = max(candidates,
                   key=lambda w: (scores[w],
                                  -(self.workers[w].busy_us + extra.get(w, 0.0)),
                                  -w))
        if scores[best] <= 0.0:
            return self.least_loaded(candidates, extra_load)
        return best

    # --------------------------------------------------------------- updates
    def note_dispatch(self, wid: int, clusters: Iterable[int]) -> None:
        st = self.workers[wid]
        st.freq *= self.decay
        cl = np.asarray(list(clusters), np.int64)
        if cl.size:
            np.add.at(st.freq, cl, 1.0)
            if self.tracker is not None:
                self.tracker.record(cl)
        st.dispatches += 1

    def note_busy(self, wid: int, dur_us: float) -> None:
        self.workers[wid].busy_us += dur_us

    def note_complete(self, wid: int, dur_us: float) -> None:
        """A dispatched job finished; its duration moves from in-flight to
        completed occupancy (mirrored into Metrics by the scheduler)."""
        self.workers[wid].completed_us += dur_us

    # ----------------------------------------------------------------- stats
    def utilization(self, now_us: float) -> list:
        """Per-worker completed-busy fraction of the virtual timeline so far
        (telemetry sampling; in [0, 1] since completed_us only accrues for
        jobs whose end instant has passed)."""
        t = max(float(now_us), 1e-9)
        return [min(w.completed_us / t, 1.0) for w in self.workers]

    def report(self) -> dict:
        busy = np.asarray([w.busy_us for w in self.workers])
        return {
            "busy_us": busy.tolist(),
            "completed_us": [w.completed_us for w in self.workers],
            "dispatches": [w.dispatches for w in self.workers],
            "busy_skew": float(busy.max() / busy.mean()) if busy.mean() > 0 else 1.0,
            "replica_routes": self.replica_routes,
        }


# ---------------------------------------------------------------------------
# SLO slack ordering
# ---------------------------------------------------------------------------


def sharded_scan_cost_us(clusters: np.ndarray, cost_model, sizes,
                         shard_map, merge_us: float) -> float:
    """Service-time estimate of scanning ``clusters`` in shard mode: the
    per-shard partial scans run in *parallel* on their owning workers, so
    the scan term is the ``max`` over shards (not the sum), plus a k-way
    merge term per participating shard charged to the scheduler-side
    gather."""
    if clusters.size == 0:
        return 0.0
    owners = shard_map.owner[clusters]
    per_cost = cost_model.cost_vec_us(sizes[clusters],
                                      np.ones(clusters.size))
    per_shard = np.bincount(owners, weights=per_cost,
                            minlength=shard_map.n_shards)
    n_parts = int((np.bincount(owners,
                               minlength=shard_map.n_shards) > 0).sum())
    return float(per_shard.max()) + merge_us * n_parts


def estimate_remaining_us(req, budget, cost_model, sizes,
                          shard_map=None, merge_us: float = 0.0,
                          pool_scale: float = 1.0) -> float:
    """First-order estimate of a request's remaining service time: the cost
    of its unsearched clusters plus its ungenerated tokens at the current
    EMA decode rate.  Later stages of the workflow are not modelled — slack
    is used for *ordering*, so only relative magnitudes matter.  With a
    ``shard_map``, the retrieval term models shard-mode scatter-gather:
    ``max`` over per-shard partial-scan costs plus a merge term, instead of
    the single-worker sum.  ``pool_scale`` (static pool / effective pool)
    inflates the estimate when workers are dead or draining."""
    from repro_torch.core import stages

    ctx = stages.CostCtx(budget=budget, cost_model=cost_model, sizes=sizes,
                         shard_map=shard_map, merge_us=merge_us)
    est = 0.0
    for prog, kind in stages.active_progress(req):
        est += stages.spec(kind).remaining_us(req, prog, ctx)
    if pool_scale != 1.0:
        est *= pool_scale
    return est


def slo_slack_us(req, now: float, budget, cost_model, sizes,
                 default_slo_us: float, shard_map=None,
                 merge_us: float = 0.0, pool_scale: float = 1.0) -> float:
    """deadline - now - estimated_remaining; negative -> already late."""
    slo = getattr(req, "slo_us", 0.0) or default_slo_us
    deadline = req.arrival_us + slo
    return deadline - now - estimate_remaining_us(
        req, budget, cost_model, sizes, shard_map, merge_us, pool_scale)


def order_by_slack(reqs, now: float, budget, cost_model, sizes,
                   default_slo_us: float, shard_map=None,
                   merge_us: float = 0.0, pool_scale: float = 1.0) -> list:
    """Wavefront order for sub-stage assembly: tightest slack first (ties
    broken by arrival so the order is deterministic)."""
    return sorted(
        reqs,
        key=lambda r: (slo_slack_us(r, now, budget, cost_model, sizes,
                                    default_slo_us, shard_map, merge_us,
                                    pool_scale),
                       r.arrival_us, r.request_id),
    )


# ---------------------------------------------------------------------------
# Streaming admission control
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdmissionDecision:
    admitted: bool
    reason: str = "admitted"  # admitted | queue_full | deadline_infeasible
    lower_bound_us: float = 0.0
    slack_us: float = float("inf")


@owned_by("scheduler")
class AdmissionController:
    """Admission policy for the streaming front-end.

    Two independent gates, each enabled by its SchedulerConfig knob:

    * ``max_pending > 0`` — bounded in-system queue: once ``max_pending``
      requests are in the system (queued + in flight), further submissions
      are shed (``queue_full``) instead of growing the backlog without
      bound past the saturation knee.
    * ``admission_control`` — deadline-infeasibility shedding: a request is
      shed (``deadline_infeasible``) when its remaining SLO slack is below
      ``shed_margin`` times a cost-model lower bound of serving it, where
      the bound is its own minimal service time (at least one smallest-
      cluster scan per retrieval node, at least one decode step per
      generation node) *plus* the queueing delay implied by the work
      already in the system (first-order remaining-time estimate of every
      in-flight request, spread over the retrieval pool).  Admitting such
      a request could only burn worker time on a guaranteed SLO violation
      and push other requests past their deadlines; ``shed_margin < 1``
      relaxes the gate (e.g. to keep requests a cross-request cache answer
      might still rescue), ``> 1`` adds headroom.

    Decisions are pure functions of (config, graph shape, clock, in-system
    load, EMA cost estimates), so a fixed workload seed yields the same
    shed set on every run.
    """

    def __init__(self, cfg, budget, cost_model, cluster_sizes,
                 shard_map=None, lifecycle=None):
        self.cfg = cfg
        self.budget = budget
        self.cost_model = cost_model
        self.sizes = np.asarray(cluster_sizes)
        self.min_cluster_size = int(self.sizes.min()) if self.sizes.size else 0
        # shard-mode cost semantics: a retrieval stage's service time is the
        # max over its per-shard partial scans plus a scheduler-side merge
        # term, not a single-worker sum over its clusters
        self.shard_map = shard_map
        self.merge_us = float(getattr(cfg, "shard_merge_us", 0.0)
                              ) if shard_map is not None else 0.0
        # worker lifecycle registry (serving.lifecycle.WorkerRegistry):
        # backlog spreads over the *effective* pool, not the static size
        self.lifecycle = lifecycle

    def effective_pool(self) -> int:
        """Workers actually able to absorb new retrieval work: the static
        pool size with every worker HEALTHY, shrinking as workers die or
        drain (0 = nothing can serve; backlog becomes unbounded)."""
        if self.lifecycle is not None and not self.lifecycle.all_healthy():
            return int(self.lifecycle.effective_pool_size())
        return max(1, int(self.cfg.num_ret_workers))

    def lower_bound_us(self, req) -> float:
        """Cost-model lower bound of serving ``req`` in isolation: each graph
        node contributes its StageSpec's minimal single-pass service time
        (one smallest-cluster scan per retrieval node, one decode step per
        generation node, one fixed+unit slice per host stage).  In shard
        mode sharding cannot shrink a single smallest-cluster scan (``max``
        over one shard == that shard), but every retrieval stage
        additionally pays at least one scatter-gather merge."""
        from repro_torch.core import stages

        counts: dict[str, int] = {}
        for n in req.graph.nodes.values():
            counts[n.kind] = counts.get(n.kind, 0) + 1
        total = 0.0
        for kind in sorted(counts):
            total += counts[kind] * stages.spec(kind).min_service_us(self)
        # impaired pool: fewer workers to overlap sub-stages onto, so even
        # the single-pass bound stretches by the static/effective ratio
        if self.lifecycle is not None and not self.lifecycle.all_healthy():
            eff = self.effective_pool()
            n_static = max(1, int(self.cfg.num_ret_workers))
            if 0 < eff < n_static:
                total *= n_static / eff
        return total

    def backlog_us(self, active) -> float:
        """Queueing-delay lower bound seen by a new arrival: the first-order
        remaining service time of everything in flight.  Whole-index mode
        spreads independent stages over the retrieval pool (``/ N``); shard
        mode does *not* divide — each request's estimate is already the
        parallel (max-over-shards) service time and scatter sets occupy the
        whole pool at once, so in-flight requests queue behind each other."""
        total = sum(
            estimate_remaining_us(r, self.budget, self.cost_model, self.sizes,
                                  self.shard_map, self.merge_us)
            for r in active)
        if total <= 0.0:
            return 0.0
        pool = self.effective_pool()
        if pool <= 0:
            return float("inf")  # nothing left to serve retrieval work
        if self.shard_map is not None:
            return total
        return total / pool

    def evaluate(self, req, now: float, queue_len: int,
                 active=()) -> AdmissionDecision:
        # load-based gates (queue bound, in-flight backlog) only apply to
        # requests entering service *now* — the streaming path, where the
        # clock has been stepped to the arrival.  A pre-loaded future
        # arrival is judged against today's load for work that may have
        # fully drained by its arrival time, so it only faces the
        # load-independent isolated-service check.
        due_now = req.arrival_us <= now
        if (due_now and self.cfg.max_pending > 0
                and queue_len >= self.cfg.max_pending):
            return AdmissionDecision(False, "queue_full")
        if not self.cfg.admission_control:
            return AdmissionDecision(True)
        slo = getattr(req, "slo_us", 0.0) or self.cfg.slo_us
        lb = self.lower_bound_us(req)
        if due_now:
            lb += self.backlog_us(active)
        # slack remaining at service start: deadline minus the later of the
        # submission clock and the request's own arrival stamp (a pre-loaded
        # future arrival still has its whole SLO ahead of it)
        slack = req.arrival_us + slo - max(now, req.arrival_us)
        if slack < self.cfg.shed_margin * lb:
            return AdmissionDecision(False, "deadline_infeasible", lb, slack)
        return AdmissionDecision(True, "admitted", lb, slack)

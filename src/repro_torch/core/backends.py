"""Execution backends for the wavefront scheduler.

``SimBackend`` — *exact results, modelled time*: retrieval work is executed
for real against the IVF index (and the hot-cache hybrid path, so cache hit
rates and result contents are genuine), but the scheduler is *charged*
calibrated-model durations.  This is how scheduling policies are compared
honestly on a single-CPU container: the paper's CPU∥GPU overlap becomes two
modelled resources with measured cost curves (Fig. 4/6 shapes), while every
search result, cache decision, reorder and speculation validation is real.

``RealBackend`` — wall-clock everything: ties the same scheduler to the JAX
generation engine (serving/engine.py) and the hybrid retrieval engine;
used by the end-to-end examples and integration tests.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.retrieval.hybrid import HybridRetrievalEngine
from repro_torch.retrieval.ivf import ClusterCostModel, IVFIndex, TopK
from repro_torch.retrieval.plan import RetrievalPlan


class SimBackend:
    def __init__(
        self,
        index: IVFIndex,
        embedder,
        *,
        hybrid: Optional[HybridRetrievalEngine] = None,
        cost_model: Optional[ClusterCostModel] = None,
        # generation cost curve (Fig. 4a shape): step(batch) = a + b*batch
        gen_step_base_us: float = 1200.0,
        gen_step_per_seq_us: float = 35.0,
        prefill_us_per_token: float = 8.0,
        gen_noise_sigma: float = 0.20,  # decode-step variation (Fig. 6a)
        # device (hot-cache) search: per-vector speedup + kernel launch cost
        device_speedup: float = 8.0,
        device_launch_us: float = 60.0,
        # fault injection
        straggler_prob: float = 0.0,
        straggler_factor: float = 4.0,
        fault_plan=None,  # serving.faults.FaultPlan: seeded chaos script
        seed: int = 0,
    ):
        self.index = index
        self.embedder = embedder
        self.hybrid = hybrid
        self.cluster_cost_model = cost_model or ClusterCostModel()
        self.gen_step_base_us = gen_step_base_us
        self.gen_step_per_seq_us = gen_step_per_seq_us
        self.prefill_us_per_token = prefill_us_per_token
        self.gen_noise_sigma = gen_noise_sigma
        self.device_speedup = device_speedup
        self.device_launch_us = device_launch_us
        self.straggler_prob = straggler_prob
        self.straggler_factor = straggler_factor
        self.fault_plan = fault_plan
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._sizes = index.cluster_sizes()
        # per-retrieval-worker timing state: independent straggler streams +
        # accumulated busy time, so multi-worker runs expose per-worker
        # stragglers and utilization skew
        self._worker_rng: dict[int, np.random.Generator] = {}
        self.worker_busy_us: dict[int, float] = {}
        # crossreq accounting: modeled cost of the duplicate scans avoided by
        # fused groups (a group with fanout f charges once, not f times)
        self.fused_saved_us = 0.0
        self._lexical = None  # lazily-built lexical channel (hybrid fusion)

    def _rng_for_worker(self, worker_id: int) -> np.random.Generator:
        rng = self._worker_rng.get(worker_id)
        if rng is None:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, worker_id + 1]))
            self._worker_rng[worker_id] = rng
        return rng

    # ----------------------------------------------------------- embeddings
    def query_embedding(self, req, round_idx: int) -> np.ndarray:
        return self.embedder.embed_query(req.request_id, round_idx)

    def partial_embedding(self, req, round_idx: int, ratio: float) -> np.ndarray:
        return self.embedder.embed_partial(req.request_id, round_idx, ratio)

    # ------------------------------------------------------------ generation
    def gen_duration(self, n_prefill_tokens: int, batch: int, n_steps: int) -> float:
        step = self.gen_step_base_us + self.gen_step_per_seq_us * batch
        noise = float(self._rng.lognormal(0.0, self.gen_noise_sigma))
        pre = self.prefill_us_per_token * n_prefill_tokens
        return (step * n_steps) * noise + pre

    # ------------------------------------------------------------- retrieval
    def search_charged(
        self, work, worker_id: int = 0,
    ) -> tuple[float, Callable]:
        """Returns (charged_us, results_fn).

        ``work`` is a :class:`RetrievalPlan` (the SoA sub-stage protocol:
        results_fn() -> the plan's item-level ``BatchTopK`` scoreboard) or a
        legacy per-item work list (results_fn() -> per-item (dists, ids)
        candidate arrays).  The plan path charges over the segment table in
        one vectorized pass, with device residency *snapshotted here* — at
        dispatch time — and threaded into execution, so the charged
        host/device partition and the executed one agree even when cache
        swaps land between dispatch and completion.
        """
        if isinstance(work, RetrievalPlan):
            return self._search_charged_plan(work, worker_id)
        if not work:
            return 0.0, lambda: []
        # --- charge: host clusters at CPU rate, resident clusters at device
        # rate; the two paths overlap (max), matching the paper's engine.
        by_cluster: dict[int, int] = {}
        for _, cid, _ in work:
            by_cluster[cid] = by_cluster.get(cid, 0) + 1
        host_us = dev_us = 0.0
        n_dev = 0
        for cid, nq in by_cluster.items():
            c = self.cluster_cost_model.cost_us(int(self._sizes[cid]), nq)
            if self.hybrid is not None and self.hybrid.cache.is_resident(cid):
                dev_us += c / self.device_speedup
                n_dev += 1
            else:
                host_us += c
        if n_dev:
            dev_us += self.device_launch_us
        charge = max(host_us, dev_us)
        self.worker_busy_us[worker_id] = (
            self.worker_busy_us.get(worker_id, 0.0) + charge)

        # --- execute exactly (records accesses, drives cache updates)
        def results_fn(work=tuple(work)) -> list:
            base = [(q, cid, TopK.empty(tk.k)) for q, cid, tk in work]
            if self.hybrid is not None:
                res, _ = self.hybrid.search_substage(base)
            else:
                res = self.index.search_cluster_batch(base)
            return [(r.dists[r.ids >= 0], r.ids[r.ids >= 0]) for r in res]

        return charge, results_fn

    def _search_charged_plan(
        self, plan: RetrievalPlan, worker_id: int,
    ) -> tuple[float, Callable]:
        """Vectorized charge over the plan's segment table + deferred exact
        execution through the plan executor."""
        seg_sizes = self._sizes[plan.seg_cluster]
        costs = self.cluster_cost_model.cost_vec_us(seg_sizes, plan.seg_counts())
        if self.hybrid is not None:
            # dispatch-time snapshot; in shard mode the executing worker
            # only sees its own slot partition (plus staged replicas)
            owner = worker_id if self.hybrid.sharded else None
            resident = self.hybrid.resident_mask(owner)
            dev = resident[plan.seg_cluster]
            host_us = float(costs[~dev].sum())
            dev_us = float(costs[dev].sum()) / self.device_speedup
            if dev.any():
                dev_us += self.device_launch_us
        else:
            resident = None
            host_us, dev_us = float(costs.sum()), 0.0
        charge = max(host_us, dev_us)
        self.worker_busy_us[worker_id] = (
            self.worker_busy_us.get(worker_id, 0.0) + charge)
        # fused groups are charged once for the whole subscriber set; account
        # the counterfactual cost the extra subscribers would have added,
        # at the rate their clusters would actually have been charged
        # (device-resident clusters at the device rate)
        fan = getattr(plan, "group_fanout", None)
        if fan is not None and fan.size and int(fan.max()) > 1:
            extra = (fan[plan.item_group] - 1).astype(np.float64)
            item_cost = self.cluster_cost_model.cost_vec_us(
                self._sizes[plan.cluster_ids], np.ones(plan.n_items))
            if resident is not None:
                item_cost = np.where(resident[plan.cluster_ids],
                                     item_cost / self.device_speedup,
                                     item_cost)
            self.fused_saved_us += float((item_cost * extra).sum())

        # --- execute exactly (records accesses, drives cache updates); the
        # snapshot rides in the closure so execution partitions like the charge
        def results_fn(plan=plan, resident=resident, worker_id=worker_id):
            if self.hybrid is not None:
                owner = worker_id if self.hybrid.sharded else None
                return self.hybrid.search_plan(plan, resident=resident,
                                               owner=owner)
            return self.index.search_plan(plan)

        return charge, results_fn

    # --------------------------------------------------------- host stages
    def stage_charged(self, task, worker_id: int = 0):
        """Modelled-cost analogue of search_charged for generic host-stage
        work (rerank/compress scoring batches): the scheduler is charged the
        StageSpec's modelled cost while the exact compute is deferred to
        completion time; a fused group charges once for the whole
        subscriber set."""
        charge = float(task.cost_us)
        self.worker_busy_us[worker_id] = (
            self.worker_busy_us.get(worker_id, 0.0) + charge)
        if task.fanout > 1:
            self.fused_saved_us += charge * (task.fanout - 1)
        return charge, task.execute

    def lexical_scores(self, text: str, doc_ids) -> dict:
        """Lexical (term-overlap) channel for dense+lexical hybrid fusion."""
        if self._lexical is None:
            from repro_torch.retrieval.lexical import LexicalScorer
            self._lexical = LexicalScorer()
        return self._lexical.scores(text, doc_ids)

    # ------------------------------------------------------ fault injection
    def maybe_straggle(self, dur: float, worker_id: int = -1) -> float:
        """Per-worker straggler streams: worker_id -1 is the generation
        worker; retrieval workers draw from independent seeded streams so a
        slow worker in one pool slot does not perturb the others."""
        if self.straggler_prob and self._rng_for_worker(worker_id).random() < self.straggler_prob:
            return dur * self.straggler_factor
        return dur

    def fault_latency(self, dur: float, worker_id: int = -1,
                      now_us: float = 0.0) -> float:
        """FaultPlan timing hook: inflate a job's service time by the stall
        window active on its worker at dispatch time.  Applied *after*
        straggler mitigation — injected stalls are what the scheduler's
        timeout/hedging layer must cover, so the straggler cap must not
        silently absorb them.  Identity without a plan."""
        if self.fault_plan is None:
            return dur
        return dur * self.fault_plan.stall_factor(worker_id, now_us)

    def worker_report(self) -> dict:
        """Per-retrieval-worker *modeled charge* (us) accumulated by
        search_charged, before straggler injection/mitigation and including
        speculative warmup items.  The scheduler-side wall occupancy (after
        mitigation) lives in ``Metrics.ret_busy_per_worker``."""
        return dict(sorted(self.worker_busy_us.items()))

    # -------------------------------------------------------- calibration
    @classmethod
    def calibrated(cls, index: IVFIndex, embedder, **kw) -> "SimBackend":
        """Measure the host cluster-search cost curve on this machine."""
        cm = ClusterCostModel.calibrate(index)
        return cls(index, embedder, cost_model=cm, **kw)


class RealBackend:
    """Wall-clock backend: real JAX generation engine + hybrid retrieval."""

    def __init__(self, gen_engine, index: IVFIndex, embedder,
                 hybrid: Optional[HybridRetrievalEngine] = None):
        self.gen_engine = gen_engine
        self.index = index
        self.embedder = embedder
        self.hybrid = hybrid or HybridRetrievalEngine(index, cache_capacity=0)
        self.cluster_cost_model = ClusterCostModel.calibrate(index)
        self._sizes = index.cluster_sizes()
        self.worker_busy_us: dict[int, float] = {}
        # modeled (calibrated cost-curve) estimate of the duplicate scans
        # avoided by crossreq-fused groups; wall time cannot measure work
        # that was never executed.  device_speedup mirrors SimBackend's
        # default so resident clusters are discounted comparably.
        self.fused_saved_us = 0.0
        self.device_speedup = 8.0
        self.fault_plan = None  # chaos scripts target the simulated clock
        self._lexical = None

    def query_embedding(self, req, round_idx: int) -> np.ndarray:
        return self.embedder.embed_query(req.request_id, round_idx)

    def partial_embedding(self, req, round_idx: int, ratio: float) -> np.ndarray:
        return self.embedder.embed_partial(req.request_id, round_idx, ratio)

    def gen_duration(self, n_prefill_tokens: int, batch: int, n_steps: int) -> float:
        """Execute n_steps of real decoding on the engine; return measured us.
        The scheduler passes the request set via bind_gen_batch beforehand."""
        # RealBackend measures *actual* execution; the virtual clock only
        # advances by these measured durations, so reading the wall clock
        # here is the sanctioned boundary between real and virtual time.
        t0 = time.perf_counter()  # repro-lint: disable=wall-clock
        self.gen_engine.step_batch(n_steps)
        return (time.perf_counter() - t0) * 1e6  # repro-lint: disable=wall-clock

    def search_charged(self, work, worker_id: int = 0):
        if isinstance(work, RetrievalPlan):
            fan = work.group_fanout
            if fan.size and int(fan.max()) > 1:
                extra = (fan[work.item_group] - 1).astype(np.float64)
                item_cost = self.cluster_cost_model.cost_vec_us(
                    self._sizes[work.cluster_ids], np.ones(work.n_items))
                # same residency discount as SimBackend so the two report
                # comparable savings (device-resident clusters are cheap)
                resident = self.hybrid.resident_mask(
                    worker_id if self.hybrid.sharded else None)
                item_cost = np.where(resident[work.cluster_ids],
                                     item_cost / self.device_speedup,
                                     item_cost)
                self.fused_saved_us += float((item_cost * extra).sum())
            # real-time measurement boundary (see gen_duration)
            t0 = time.perf_counter()  # repro-lint: disable=wall-clock
            batch = self.hybrid.search_plan(
                work, owner=worker_id if self.hybrid.sharded else None)
            measured = (time.perf_counter() - t0) * 1e6  # repro-lint: disable=wall-clock
            self.worker_busy_us[worker_id] = (
                self.worker_busy_us.get(worker_id, 0.0) + measured)
            return measured, lambda: batch
        if not work:
            return 0.0, lambda: []
        # real-time measurement boundary (see gen_duration)
        t0 = time.perf_counter()  # repro-lint: disable=wall-clock
        base = [(q, cid, TopK.empty(tk.k)) for q, cid, tk in work]
        res, timing = self.hybrid.search_substage(base)
        out = [(r.dists[r.ids >= 0], r.ids[r.ids >= 0]) for r in res]
        measured = (time.perf_counter() - t0) * 1e6  # repro-lint: disable=wall-clock
        self.worker_busy_us[worker_id] = (
            self.worker_busy_us.get(worker_id, 0.0) + measured)
        return measured, lambda: out

    def stage_charged(self, task, worker_id: int = 0):
        """Wall-clock host-stage execution: run the batch now, charge the
        measured time, hand completion a closure over the result."""
        if task.fanout > 1:
            self.fused_saved_us += float(task.cost_us) * (task.fanout - 1)
        # real-time measurement boundary (see gen_duration)
        t0 = time.perf_counter()  # repro-lint: disable=wall-clock
        result = task.execute()
        measured = (time.perf_counter() - t0) * 1e6  # repro-lint: disable=wall-clock
        self.worker_busy_us[worker_id] = (
            self.worker_busy_us.get(worker_id, 0.0) + measured)
        return measured, lambda: result

    def lexical_scores(self, text: str, doc_ids) -> dict:
        if self._lexical is None:
            from repro_torch.retrieval.lexical import LexicalScorer
            self._lexical = LexicalScorer()
        return self._lexical.scores(text, doc_ids)

    def maybe_straggle(self, dur: float, worker_id: int = -1) -> float:
        return dur

    def fault_latency(self, dur: float, worker_id: int = -1,
                      now_us: float = 0.0) -> float:
        if self.fault_plan is None:
            return dur
        return dur * self.fault_plan.stall_factor(worker_id, now_us)

    def worker_report(self) -> dict:
        return dict(sorted(self.worker_busy_us.items()))

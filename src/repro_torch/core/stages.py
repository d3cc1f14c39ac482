"""Stage registry: the behavioural half of the stage-polymorphic node model.

``ragraph.py`` keeps nodes as plain frozen data tagged with a ``kind``
string; everything a scheduler layer needs to *do* with a stage lives here,
behind one ``StageSpec`` per kind:

* entry/completion — ``enter`` (re)initialises per-request progress when a
  request sits at a fresh node (instant completions loop in the caller),
  ``write_output`` folds the finished stage's result into request state;
* splitting — ``unit_cost_us`` + the generic ``assemble`` drive
  ``transforms.split_stage_next`` under ``TimeBudget.units_for_budget``
  (Eq. 1 applied to any splittable unit queue: IVF clusters, candidate
  blocks, query variants);
* cost profile — ``min_service_us`` feeds the admission controller's
  isolated-service lower bound and ``remaining_us`` the SLO-slack
  estimator (``serving/dispatch.py``), so new stage kinds are admission-
  and slack-aware without touching either;
* cross-request fusion — ``fusion_signature`` produces the
  (key, bucket, unit-vec) triple ``crossreq/dedup.py`` matches on, so
  rerank/rewrite stages dedup across requests exactly like retrieval;
* speculation capabilities — class flags (``emits_partial_queries``,
  ``accepts_probe_warmup``, ``supports_spec_start``) replace the scheduler's
  old hard-wired kind checks.

The scheduler (``core/wavefront.py``) dispatches exclusively through
``spec_for(node)`` / ``spec(kind)``; registering a new kind via
``register_stage`` is all it takes to plug a stage type into splitting,
slack ordering, admission control, dedup/fusion and the serving loop.

Built-in kinds: ``generation`` and ``retrieval`` (the paper's Listing 1
pair — their spec bodies are verbatim moves of the pre-registry scheduler
branches, pinned bit-identical by ``tests/golden_fingerprints.json``), plus
``rerank`` (cross-encoder candidate scoring), ``rewrite`` (multi-query
expansion with BatchTopK k-way merge) and ``compress`` (extractive
block-saliency compression).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core import similarity, transforms
from repro_torch.core.ragraph import (CompressNode, GenerationNode, RerankNode,
                                RetrievalNode, RewriteNode)
from repro_torch.core.runtime import GenProgress, RetProgress, StageProgress
from repro_torch.core.similarity import LocalCache
from repro_torch.retrieval.ivf import TopK
from repro_torch.retrieval.plan import BatchTopK

# resource classes: which worker pool executes the stage
GEN = "gen"  # the accelerator-side generation worker
HOST = "ret"  # the host-side retrieval worker pool


# ---------------------------------------------------------------------------
# Cross-layer value types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FusionSig:
    """What the in-flight dedup/fusion pass matches on.  ``key`` is the
    exact byte-hash identity (stage kind + query payload + knobs);
    ``bucket`` partitions near-match comparisons (kind + result-shape knobs,
    so fused answers keep the subscriber's k/nprobe); ``unit_vec`` is the
    normalised query for cosine near-matching, or None for exact-only
    stages (rerank/compress, whose results are candidate-set specific)."""

    key: bytes
    bucket: tuple
    unit_vec: Optional[np.ndarray] = None


@dataclasses.dataclass
class CostCtx:
    """Cost-model context handed to ``remaining_us`` by the slack/admission
    estimators (serving/dispatch.py)."""

    budget: Any  # core.substage.TimeBudget
    cost_model: Any  # retrieval.ivf.ClusterCostModel
    sizes: Any  # per-cluster vector counts
    shard_map: Any = None
    merge_us: float = 0.0


@dataclasses.dataclass
class StageTask:
    """One dispatched batch of generic host-stage work units (the host-task
    analogue of a retrieval plan group).  ``execute`` is the deferred pure
    compute; backends charge ``cost_us`` (sim) or the measured wall time
    (real) via ``stage_charged``."""

    kind: str
    req: Any  # runtime.RequestContext
    units: list
    cost_us: float
    fanout: int  # fused-group width at dispatch time (charge once)
    execute: Callable[[], Any]
    sn: Any = None  # runtime-DAG sub-node covering the batch


@dataclasses.dataclass(frozen=True)
class StageCostProfile:
    fixed_us: float  # per-dispatched-batch overhead
    unit_us: float  # per elementary work item (candidate doc, ...)


# ---------------------------------------------------------------------------
# The spec protocol
# ---------------------------------------------------------------------------


class StageSpec:
    """Behaviour of one stage kind.  Subclasses override the hooks their
    resource class needs; the base provides inert defaults so a minimal new
    stage only implements ``enter``/``write_output``/``min_service_us``."""

    kind: str = ""
    resource: str = HOST
    splittable: bool = False
    # speculation capabilities (paper §4.3) — replace hard-wired kind checks
    emits_partial_queries: bool = False  # gen->ret: partial output embeds
    accepts_probe_warmup: bool = False  # ret-side LocalCache warmups apply
    supports_spec_start: bool = False  # ret->gen: may pre-start this stage

    # ------------------------------------------------------- declared wiring
    def inputs(self, node) -> list:
        return node.inputs()

    def outputs(self, node) -> list:
        return [node.output]

    # --------------------------------------------------------- stage entry
    def probe_hint_nprobe(self, node, cfg) -> Optional[int]:
        """nprobe for the batched arrival-time probe_order prefetch, or None
        when the stage does not consume a probe hint."""
        return None

    def enter(self, sched, req, now) -> bool:
        """(Re)initialise progress at a fresh node.  Returns True when the
        stage completed instantly (the scheduler loops to the next node)."""
        raise NotImplementedError

    # --------------------------------------------------------- cost profile
    def min_service_us(self, adm) -> float:
        """Isolated-service lower bound per node of this kind (admission
        control; ``adm`` is the AdmissionController)."""
        raise NotImplementedError

    def remaining_us(self, req, prog, ctx: CostCtx) -> float:
        """First-order remaining-service estimate for an active progress
        record (SLO-slack ordering)."""
        return 0.0

    # ------------------------------------------------- cross-request fusion
    def fusion_fresh(self, req) -> bool:
        """True while the stage has not executed any work yet (only fresh
        stages may subscribe to, or lead, a fused group)."""
        return False

    def fusion_signature(self, sched, req) -> Optional[FusionSig]:
        return None

    def park_subscriber(self, sched, req) -> None:
        raise NotImplementedError

    def adopt_from_leader(self, sched, sub, leader, match, now) -> None:
        raise NotImplementedError

    # -------------------------------------------------------- host assembly
    def assemble(self, sched, req, builders, tasks, cycle_load, idle, now,
                 *, whole_stage: bool) -> None:
        """Split off the next sub-stage under the time budget and dispatch
        it to the worker pool (plan groups and/or StageTasks)."""
        raise NotImplementedError

    def complete_plan_group(self, sched, req, ref, res, g, kg, now) -> None:
        """A plan group dispatched by ``assemble`` landed (meta tag
        ``("stage", req, spec, ref)``)."""
        raise NotImplementedError

    def complete_task(self, sched, task: StageTask, result, now) -> None:
        """A StageTask dispatched by ``assemble`` landed."""
        raise NotImplementedError

    # ----------------------------------------------------------- completion
    def write_output(self, sched, req, now) -> None:
        """Fold the finished stage's result into ``req.state``."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

STAGE_REGISTRY: dict[str, StageSpec] = {}


def register_stage(spec: StageSpec) -> StageSpec:
    if not spec.kind:
        raise ValueError("stage spec must declare a kind")
    STAGE_REGISTRY[spec.kind] = spec
    return spec


def spec(kind: str) -> StageSpec:
    try:
        return STAGE_REGISTRY[kind]
    except KeyError:
        raise KeyError(
            f"no StageSpec registered for kind {kind!r}; known kinds: "
            f"{sorted(STAGE_REGISTRY)} — register one via "
            f"repro_torch.core.stages.register_stage") from None


def spec_for(node) -> StageSpec:
    return spec(node.kind)


def active_progress(req) -> list:
    """(progress, kind) pairs for every unfinished stage progress a request
    carries — the iteration order (ret, gen, stage) matches the legacy
    slack estimator so summation order (and float results) are unchanged."""
    out = []
    if req.ret is not None and not req.ret.done:
        out.append((req.ret, "retrieval"))
    if req.gen is not None and not req.gen.done:
        out.append((req.gen, "generation"))
    st = req.stage
    if st is not None and not st.done:
        out.append((st, st.kind))
    return out


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


class GenerationSpec(StageSpec):
    kind = "generation"
    resource = GEN
    splittable = True  # by decode steps (continuous batching)
    emits_partial_queries = True
    supports_spec_start = True

    def enter(self, sched, req, now) -> bool:
        node = req.node
        if req.gen is None:
            tgt = sched.workload.gen_tokens(req.request_id, node.node_id,
                                            node.max_tokens)
            req.gen = GenProgress(target_tokens=tgt, started_at=now,
                                  node_id=node.node_id)
            req.log(now, "gen_stage_start", node.node_id)
        return False

    def min_service_us(self, adm) -> float:
        # at least one decode step at the current EMA step cost
        return adm.budget.t_decode_step_us

    def remaining_us(self, req, prog, ctx: CostCtx) -> float:
        remaining = max(prog.target_tokens - prog.generated, 0)
        return remaining * ctx.budget.t_decode_step_us


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------


class RetrievalSpec(StageSpec):
    kind = "retrieval"
    resource = HOST
    splittable = True  # by IVF cluster
    accepts_probe_warmup = True

    def probe_hint_nprobe(self, node, cfg) -> Optional[int]:
        return node.nprobe or cfg.nprobe

    def enter(self, sched, req, now) -> bool:
        node = req.node
        if req.ret is not None:
            return False
        nprobe = node.nprobe or sched.cfg.nprobe
        hint = sched._probe_hints.pop(req.request_id, None)
        if hint is not None:
            qv, queue = hint
            queue = list(queue)
        else:
            qv = sched.backend.query_embedding(req, req.round_idx)
            queue = [int(c) for c in
                     sched.index.probe_order(qv[None], nprobe)[0]]
        req.ret = RetProgress(
            query_vec=qv, cluster_queue=queue,
            topk=TopK.empty(node.topk or sched.cfg.topk),
            k=node.topk or sched.cfg.topk, nprobe=nprobe, started_at=now,
        )
        if req.sim_cache is None:
            req.sim_cache = LocalCache()
        req.log(now, "ret_stage_start", node.node_id)
        if sched.cfg.enable_reorder or sched.cfg.enable_cache_answer:
            rep = transforms.reorder_retrieval(req)
            if rep["reordered"]:
                sched.metrics.reorders += 1
            if rep["cache_answer"] and sched.cfg.enable_cache_answer:
                sched.metrics.cache_answers += 1
                sched._finish_ret_stage(req, now)
                return True  # advanced; maybe next stage is instant too
            if rep["cache_answer"]:
                # cache answers disabled: restore full queue
                req.ret.answered_from_cache = False
        # cross-request semantic cache: conclusive answer (exact-key
        # or O1 ball bound), else inherit the nearest hot entry's
        # H_v/C_v when this request has no local history of its own
        if (sched.crossreq is not None
                and sched.crossreq.global_cache is not None
                and not req.ret.done):
            ans, ent = sched.crossreq.global_cache.consult(
                req.ret.query_vec, req.ret.k, req.ret.nprobe,
                allow_answer=sched.cfg.enable_cache_answer,
                allow_seed=sched.cfg.enable_reorder and (
                    req.sim_cache is None or req.sim_cache.empty))
            if ans is not None:
                req.ret.topk = req.ret.topk.merge(*ans)
                req.ret.answered_from_cache = True
                req.ret.cluster_queue = []
                sched.metrics.global_cache_answers += 1
                sched._finish_ret_stage(req, now)
                return True  # advanced; maybe next stage is instant too
            if ent is not None:
                seeded = similarity.reorder_clusters(
                    req.ret.cluster_queue, ent)
                req.ret.cluster_queue = seeded.order
                sched.metrics.global_cache_seeds += 1
        if not sched.cfg.mode == "hedra":
            sched._ret_fifo.append(req)
        return False

    def min_service_us(self, adm) -> float:
        # one smallest-cluster scan; in shard mode sharding cannot shrink a
        # single smallest-cluster scan (max over one shard == that shard)
        # but every stage additionally pays one scatter-gather merge
        return adm.cost_model.cost_us(adm.min_cluster_size) + adm.merge_us

    def remaining_us(self, req, prog, ctx: CostCtx) -> float:
        if not prog.cluster_queue:
            return 0.0
        queued = np.asarray(prog.cluster_queue, np.int64)
        if ctx.shard_map is None:
            return ctx.cost_model.batch_cost_us(ctx.sizes[queued])
        from repro_torch.serving.dispatch import sharded_scan_cost_us
        return sharded_scan_cost_us(queued, ctx.cost_model, ctx.sizes,
                                    ctx.shard_map, ctx.merge_us)

    # ------------------------------------------------------------ fusion
    def fusion_fresh(self, req) -> bool:
        return not req.ret.searched

    def fusion_signature(self, sched, req) -> FusionSig:
        r = req.ret
        key = (b"retrieval|"
               + np.asarray(r.query_vec, np.float32).tobytes()
               + np.array([r.k, r.nprobe], np.int64).tobytes())
        q = np.asarray(r.query_vec, np.float64)
        unit = q / max(float(np.linalg.norm(q)), 1e-12)
        return FusionSig(key, ("retrieval", r.k, r.nprobe), unit)

    def park_subscriber(self, sched, req) -> None:
        req.ret._inflight = True  # type: ignore[attr-defined]

    # (retrieval fan-out lives in the scheduler's _crossreq_stage_done —
    # it predates the registry and carries the LocalCache soundness logic)

    # -------------------------------------------------------- completion
    def write_output(self, sched, req, now) -> None:
        node = req.node
        ids = req.ret.topk.ids
        out = [int(i) for i in ids if i >= 0]
        if getattr(node, "lexical_weight", 0.0) > 0.0 and out:
            # dense+lexical hybrid fusion: rescore the stage's final dense
            # top-k with the backend's lexical (term-match) scorer and fold
            # via weighted reciprocal-rank fusion — an instant transform at
            # stage completion, like reorders.  lexical_weight == 0 keeps
            # the pure dense path bit-identical to the pre-hybrid behaviour.
            from repro_torch.retrieval.lexical import rrf_fuse
            text = req.state.get(node.query, req.state.get("input", ""))
            if isinstance(text, dict):
                text = text.get("text", "")
            lex = sched.backend.lexical_scores(str(text), out)
            out = rrf_fuse(out, lex, node.lexical_weight)
            sched.metrics.lexical_fusions += 1
            req.log(now, "lexical_fused", node.node_id)
        req.state[node.output] = out
        # stash the stage's query embedding for downstream rerank/compress
        # anchoring (state keys are runtime-internal, invisible to the
        # event fingerprint and the journal)
        req.state[f"_qv_{node.output}"] = req.ret.query_vec


# ---------------------------------------------------------------------------
# Generic host stages (rerank / compress / rewrite share the machinery)
# ---------------------------------------------------------------------------


class HostStageSpec(StageSpec):
    """Shared machinery for registry host stages executed as generic work-
    unit queues (StageProgress): budgeted splitting via
    ``transforms.split_stage_next``, dispatch through the same worker pool /
    dispatcher as retrieval, exact-key cross-request fusion."""

    resource = HOST
    splittable = True
    profile = StageCostProfile(fixed_us=0.0, unit_us=0.0)

    # ------------------------------------------------------ subclass hooks
    def open_progress(self, sched, req, now) -> StageProgress:
        raise NotImplementedError

    def unit_cost_us(self, sched, req, unit) -> float:
        n = len(unit) if isinstance(unit, (list, tuple)) else 1
        return self.profile.unit_us * n

    def make_execute(self, sched, req, units) -> Callable[[], Any]:
        raise NotImplementedError

    def fold(self, sched, req, result) -> None:
        """Fold a completed batch's result into the stage payload."""
        raise NotImplementedError

    def on_adopt(self, sched, sub, leader) -> None:
        """Extra subscriber-side state on fused adoption (optional)."""

    # ------------------------------------------------------------- entry
    def enter(self, sched, req, now) -> bool:
        node = req.node
        if req.stage is not None:
            return False
        req.stage = prog = self.open_progress(sched, req, now)
        prog.started_at = now
        req.log(now, f"{self.kind}_stage_start", node.node_id)
        if prog.done:
            # degenerate stage (no candidates): completes instantly
            sched._finish_stage(req, now)
            return True
        if not sched.cfg.mode == "hedra":
            sched._ret_fifo.append(req)
        return False

    # ---------------------------------------------------------- assembly
    def assemble(self, sched, req, builders, tasks, cycle_load, idle, now,
                 *, whole_stage: bool) -> None:
        prog = req.stage
        costs = (None if whole_stage else
                 [self.unit_cost_us(sched, req, u) for u in prog.work_queue])
        sn = transforms.split_stage_next(sched.dag, req, sched.budget, costs,
                                         whole_stage=whole_stage)
        if sn is None:
            return
        units = sn.payload["units"]
        prog.work_queue = prog.work_queue[len(units):]
        prog.inflight_units += len(units)
        self.dispatch_units(sched, req, units, sn, builders, tasks,
                            cycle_load, idle, now)

    def dispatch_units(self, sched, req, units, sn, builders, tasks,
                       cycle_load, idle, now) -> None:
        """Default dispatch: one StageTask on a policy-picked worker, with
        candidate-doc cluster ownership as the affinity signal."""
        flat = [int(d) for blk in units for d in blk]
        aff = (sched.index.doc_cluster(np.asarray(flat, np.int64))
               if flat else np.zeros(0, np.int64))
        wid = sched.dispatcher.pick_worker([int(c) for c in aff], idle,
                                           extra_load=cycle_load)
        cost = self.profile.fixed_us + sum(
            self.unit_cost_us(sched, req, u) for u in units)
        fanout = 1
        if sched.crossreq is not None and sched.crossreq.fusion is not None:
            fanout = sched.crossreq.fusion.fanout(req.request_id)
        task = StageTask(self.kind, req, list(units), float(cost), fanout,
                         self.make_execute(sched, req, units), sn)
        tasks[wid].append(task)
        sched.dispatcher.note_dispatch(wid, [int(c) for c in aff])
        cycle_load[wid] = cycle_load.get(wid, 0.0) + float(cost)
        sched.metrics.stage_tasks += 1

    # -------------------------------------------------------- completion
    def complete_task(self, sched, task: StageTask, result, now) -> None:
        req = task.req
        if task.sn is not None:
            sched.dag.complete(task.sn)
        prog = req.stage
        if req.finished or prog is None or prog.kind != self.kind:
            return
        self.fold(sched, req, result)
        prog.inflight_units -= len(task.units)
        if prog.done:
            sched._finish_stage(req, now)

    # ------------------------------------------------------------ fusion
    def fusion_fresh(self, req) -> bool:
        prog = req.stage
        return (not prog.parked and prog.inflight_units == 0
                and len(prog.work_queue) == prog.total_units)

    def park_subscriber(self, sched, req) -> None:
        req.stage.parked = True

    def adopt_from_leader(self, sched, sub, leader, match, now) -> None:
        node = sub.node
        prog = sub.stage
        prog.parked = False
        prog.work_queue = []
        prog.inflight_units = 0
        sub.state[node.output] = list(leader.state[leader.node.output])
        self.on_adopt(sched, sub, leader)
        sub.log(now, f"{self.kind}_stage_done", node.node_id)
        sched._advance_request(sub, now)

    # --------------------------------------------------------------- util
    def _anchor_vec(self, sched, req, docs_key) -> np.ndarray:
        """Query embedding anchoring the scoring: the producing retrieval/
        rewrite stage's stashed vector, else a fresh embed of the request."""
        qv = req.state.get(f"_qv_{docs_key}")
        if qv is None:
            qv = sched.backend.query_embedding(req, req.round_idx)
        return np.asarray(qv, np.float32)

    def _block_progress(self, sched, req, docs_key, block) -> StageProgress:
        cand = [int(i) for i in req.state.get(docs_key, [])]
        qv = self._anchor_vec(sched, req, docs_key)
        blocks = [cand[i:i + block] for i in range(0, len(cand), block)]
        return StageProgress(
            kind=self.kind, work_queue=blocks, total_units=len(blocks),
            payload={"qv": qv, "scores": {}, "n_cand": len(cand)})

    def _exact_sig(self, req, docs_key, *params) -> FusionSig:
        prog = req.stage
        qv = np.asarray(prog.payload["qv"], np.float32)
        cand = [int(i) for i in req.state.get(docs_key, [])]
        key = (f"{self.kind}|".encode()
               + qv.tobytes()
               + np.array(list(params) + cand, np.int64).tobytes())
        return FusionSig(key, (self.kind,) + tuple(params), None)


# ---------------------------------------------------------------------------
# Rerank
# ---------------------------------------------------------------------------


def cross_encoder_scores(index, qv: np.ndarray, doc_ids) -> dict:
    """Synthetic cross-encoder: a nonlinear query-document interaction model
    (saturating per-dimension interaction map + global match), deliberately
    *not* monotone in L2 distance so reranking genuinely permutes the dense
    order.  Pure and deterministic; both backends execute the same math
    (sim defers it behind a modelled charge, real times it)."""
    if not len(doc_ids):
        return {}
    D = index.doc_vectors(doc_ids)
    q = np.asarray(qv, np.float32)
    inter = np.tanh(D * q[None, :]).sum(-1)  # per-dim interaction features
    match = np.tanh(D @ q)  # global semantic match
    score = match + 0.5 * inter
    return {int(d): float(s) for d, s in zip(doc_ids, score)}


class RerankSpec(HostStageSpec):
    kind = "rerank"
    # cross-encoder pair scoring is expensive relative to an IVF scan probe:
    # ~60us per (query, doc) pair in the modelled host cost
    profile = StageCostProfile(fixed_us=250.0, unit_us=60.0)

    def open_progress(self, sched, req, now) -> StageProgress:
        return self._block_progress(sched, req, req.node.docs, req.node.block)

    def make_execute(self, sched, req, units):
        qv = req.stage.payload["qv"]
        ids = [int(d) for blk in units for d in blk]
        index = sched.index

        def execute():
            return cross_encoder_scores(index, qv, ids)

        return execute

    def fold(self, sched, req, result) -> None:
        req.stage.payload["scores"].update(result)

    def fusion_signature(self, sched, req) -> FusionSig:
        return self._exact_sig(req, req.node.docs, req.node.keep)

    def min_service_us(self, adm) -> float:
        return self.profile.fixed_us + self.profile.unit_us

    def remaining_us(self, req, prog, ctx: CostCtx) -> float:
        n = sum(len(b) for b in prog.work_queue)
        return self.profile.fixed_us + self.profile.unit_us * n if n else 0.0

    def write_output(self, sched, req, now) -> None:
        node = req.node
        scores = req.stage.payload["scores"]
        order = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        req.state[node.output] = [int(d) for d, _ in order[:node.keep]]
        req.state[f"_qv_{node.output}"] = req.stage.payload["qv"]


# ---------------------------------------------------------------------------
# Compress
# ---------------------------------------------------------------------------


def compression_scores(index, qv: np.ndarray, doc_ids, block: int) -> dict:
    """Extractive-compression saliency: training/compression.py's per-block
    absmax scale rule as the information-density proxy, crossed with query
    affinity so kept context is both dense and on-topic."""
    if not len(doc_ids):
        return {}
    from repro_torch.training.compression import block_saliency

    D = index.doc_vectors(doc_ids)
    q = np.asarray(qv, np.float32)
    sal = block_saliency(D, block)
    affinity = 1.0 / (1.0 + np.sqrt(((D - q[None, :]) ** 2).sum(-1)))
    score = sal * affinity
    return {int(d): float(s) for d, s in zip(doc_ids, score)}


class CompressSpec(HostStageSpec):
    kind = "compress"
    profile = StageCostProfile(fixed_us=150.0, unit_us=25.0)

    def open_progress(self, sched, req, now) -> StageProgress:
        return self._block_progress(sched, req, req.node.docs, req.node.block)

    def make_execute(self, sched, req, units):
        qv = req.stage.payload["qv"]
        ids = [int(d) for blk in units for d in blk]
        index = sched.index
        block = req.node.block

        def execute():
            return compression_scores(index, qv, ids, block)

        return execute

    def fold(self, sched, req, result) -> None:
        req.stage.payload["scores"].update(result)

    def fusion_signature(self, sched, req) -> FusionSig:
        ratio_pm = int(round(req.node.ratio * 1_000_000))
        return self._exact_sig(req, req.node.docs, ratio_pm)

    def min_service_us(self, adm) -> float:
        return self.profile.fixed_us + self.profile.unit_us

    def remaining_us(self, req, prog, ctx: CostCtx) -> float:
        n = sum(len(b) for b in prog.work_queue)
        return self.profile.fixed_us + self.profile.unit_us * n if n else 0.0

    def write_output(self, sched, req, now) -> None:
        node = req.node
        pl = req.stage.payload
        keep = max(1, int(round(pl["n_cand"] * node.ratio)))
        order = sorted(pl["scores"].items(), key=lambda kv: (-kv[1], kv[0]))
        req.state[node.output] = [int(d) for d, _ in order[:keep]]
        req.state[f"_qv_{node.output}"] = pl["qv"]


# ---------------------------------------------------------------------------
# Rewrite (multi-query expansion)
# ---------------------------------------------------------------------------


class RewriteSpec(HostStageSpec):
    kind = "rewrite"

    def open_progress(self, sched, req, now) -> StageProgress:
        node = req.node
        base = np.asarray(
            sched.backend.query_embedding(req, req.round_idx), np.float32)
        nprobe = node.nprobe or sched.cfg.nprobe
        k = node.topk or sched.cfg.topk
        n = max(1, int(node.n_queries))
        d = base.shape[0]
        # deterministic query expansion: variant 0 is the base query, the
        # rest add seeded isotropic noise scaled to ~25% of the query norm
        scale = 0.25 * float(np.linalg.norm(base)) / max(float(np.sqrt(d)), 1.0)
        variants = [base]
        for i in range(1, n):
            rng = np.random.default_rng(
                np.random.SeedSequence([1009, req.request_id, req.round_idx, i]))
            v = base + scale * rng.standard_normal(d).astype(np.float32)
            variants.append(np.asarray(v, np.float32))
        probes = sched.index.probe_order(np.stack(variants), nprobe)
        return StageProgress(
            kind=self.kind, work_queue=list(range(n)), total_units=n,
            payload={
                "base": base, "k": k, "nprobe": nprobe,
                "variants": variants,
                "probes": [[int(c) for c in row] for row in probes],
                # the k-way merge board: one row per variant, folded through
                # the shared BatchTopK merge at stage completion
                "board": BatchTopK.empty(n, k),
                "sn_pending": {},
            })

    def unit_cost_us(self, sched, req, unit) -> float:
        probes = req.stage.payload["probes"][unit]
        return float(sched.backend.cluster_cost_model.batch_cost_us(
            sched._cluster_sizes[np.asarray(probes, np.int64)]))

    def dispatch_units(self, sched, req, units, sn, builders, tasks,
                       cycle_load, idle, now) -> None:
        """Variant scans are real IVF work: dispatch one plan group per
        variant through the same PlanBuilder path as retrieval sub-stages
        (affinity placement, popularity feed, fused-group charging)."""
        prog = req.stage
        pl = prog.payload
        cm = sched.backend.cluster_cost_model
        fanout = 1
        if sched.crossreq is not None and sched.crossreq.fusion is not None:
            fanout = sched.crossreq.fusion.fanout(req.request_id)
        pl["sn_pending"][sn.sid] = [sn, len(units)]
        for vi in units:
            probes = pl["probes"][vi]
            wid = sched.dispatcher.pick_worker(probes, idle,
                                               extra_load=cycle_load)
            builders[wid].add(pl["variants"][vi], probes, k=pl["k"],
                              meta=("stage", req, self, (int(vi), sn.sid)),
                              fanout=fanout)
            sched.dispatcher.note_dispatch(wid, probes)
            cycle_load[wid] = cycle_load.get(wid, 0.0) + float(
                cm.batch_cost_us(
                    sched._cluster_sizes[np.asarray(probes, np.int64)]))
        sched.metrics.stage_tasks += len(units)

    def complete_plan_group(self, sched, req, ref, res, g, kg, now) -> None:
        vi, sid = ref
        prog = req.stage
        if req.finished or prog is None or prog.kind != self.kind:
            return
        pl = prog.payload
        row = res.group_topk(g, kg)
        pl["board"].merge_rows(np.array([vi], np.int64),
                               row.dists[None], row.ids[None])
        pending = pl["sn_pending"].get(sid)
        if pending is not None:
            pending[1] -= 1
            if pending[1] <= 0:
                sched.dag.complete(pending[0])
                del pl["sn_pending"][sid]
        prog.inflight_units -= 1
        if prog.done:
            sched._finish_stage(req, now)

    def min_service_us(self, adm) -> float:
        # one variant = at least one smallest-cluster scan (+ shard merge)
        return adm.cost_model.cost_us(adm.min_cluster_size) + adm.merge_us

    def remaining_us(self, req, prog, ctx: CostCtx) -> float:
        est = 0.0
        for vi in prog.work_queue:
            probes = np.asarray(prog.payload["probes"][vi], np.int64)
            est += ctx.cost_model.batch_cost_us(ctx.sizes[probes])
        return est

    def fusion_signature(self, sched, req) -> FusionSig:
        pl = req.stage.payload
        base = np.asarray(pl["base"], np.float32)
        node = req.node
        params = (pl["k"], int(node.n_queries), pl["nprobe"])
        key = (b"rewrite|" + base.tobytes()
               + np.array(params, np.int64).tobytes())
        q = np.asarray(base, np.float64)
        unit = q / max(float(np.linalg.norm(q)), 1e-12)
        return FusionSig(key, ("rewrite",) + params, unit)

    def on_adopt(self, sched, sub, leader) -> None:
        sub.state[f"_qv_{sub.node.output}"] = sub.stage.payload["base"]
        sub.round_idx += 1

    def write_output(self, sched, req, now) -> None:
        node = req.node
        pl = req.stage.payload
        board = pl["board"]
        k = pl["k"]
        # k-way merge of the per-variant top-k rows through the shared
        # BatchTopK fold, then first-occurrence doc-id dedup in ascending
        # distance order (a doc found by several variants counts once)
        fold = BatchTopK.empty(1, board.n * k)
        fold.merge_rows(np.zeros(1, np.int64),
                        board.dists.reshape(1, -1),
                        board.ids.reshape(1, -1))
        seen: set = set()
        out: list = []
        for doc in fold.ids[0]:
            doc = int(doc)
            if doc < 0 or doc in seen:
                continue
            seen.add(doc)
            out.append(doc)
            if len(out) >= k:
                break
        req.state[node.output] = out
        req.state[f"_qv_{node.output}"] = pl["base"]
        # the expansion consumed this round's query embedding
        req.round_idx += 1


register_stage(GenerationSpec())
register_stage(RetrievalSpec())
register_stage(RerankSpec())
register_stage(RewriteSpec())
register_stage(CompressSpec())

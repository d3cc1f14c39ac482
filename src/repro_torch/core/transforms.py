"""Graph transformation operators over the runtime sub-node DAG (paper §4).

Each of the paper's four transformation families is a concrete operator with
an estimated-benefit hook, applied by the scheduler to the current wavefront:

  node splitting        split_generation_next / split_retrieval_next
  reordering            reorder_retrieval  (O2/O3 cluster ordering)
  edge addition         add_speculative_generation / add_speculative_retrieval
  dependency rewiring   validate_or_rollback (spec edge resolution), plus
                        RuntimeDAG.rewire for straggler re-dispatch

The operators mutate (RuntimeDAG, RequestContext) and return the materialised
sub-nodes; estimated latency shifts are what §4.5's scheduler sorts on.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.runtime import RequestContext, RuntimeDAG, SubNode
from repro_torch.core.similarity import (
    LocalCache,
    answer_from_cache,
    early_termination_possible,
    patience_termination,
    reorder_clusters,
)
from repro_torch.core.substage import TimeBudget
from repro_torch.core.speculation import Speculator


# ---------------------------------------------------------------------------
# Node splitting (C3)
# ---------------------------------------------------------------------------


def split_generation_next(dag: RuntimeDAG, req: RequestContext,
                          budget: TimeBudget, batch_hint: int = 1,
                          speculative: bool = False,
                          deps=()) -> SubNode:
    """Materialise the next generation sub-node (n decode steps)."""
    assert req.gen is not None
    n = budget.gen_steps_for_budget(batch_hint)
    n = min(n, max(req.gen.target_tokens - req.gen.generated, 1))
    return dag.new_subnode(req, "gen", {"n_steps": n}, deps=deps,
                           speculative=speculative)


def split_retrieval_next(dag: RuntimeDAG, req: RequestContext,
                         budget: TimeBudget, cost_model, sizes,
                         speculative: bool = False, deps=()) -> Optional[SubNode]:
    """Materialise the next retrieval sub-node: clusters admitted from the
    (already reordered) queue until the Eq.(1) budget fills."""
    assert req.ret is not None
    if not req.ret.cluster_queue:
        return None
    n = budget.clusters_for_budget(req.ret.cluster_queue, cost_model, sizes)
    clusters = req.ret.cluster_queue[:n]
    return dag.new_subnode(req, "ret", {"clusters": list(clusters)}, deps=deps,
                           speculative=speculative)


def split_stage_next(dag: RuntimeDAG, req: RequestContext,
                     budget: TimeBudget, unit_costs,
                     *, whole_stage: bool = False,
                     speculative: bool = False, deps=()) -> Optional[SubNode]:
    """Materialise the next sub-node of a generic registry host stage
    (rerank / rewrite / compress / ...): work units admitted from the head
    of the stage queue until the Eq.(1) budget fills (the whole queue for
    coarse whole-stage dispatch).  ``unit_costs`` is the per-unit cost list
    the owning StageSpec computed — the registry's sub-stage factory, the
    direct analogue of ``split_retrieval_next`` for non-cluster units."""
    st = req.stage
    assert st is not None
    if not st.work_queue:
        return None
    n = (len(st.work_queue) if whole_stage
         else budget.units_for_budget(unit_costs))
    units = list(st.work_queue[:n])
    return dag.new_subnode(req, st.kind, {"units": units}, deps=deps,
                           speculative=speculative)


# ---------------------------------------------------------------------------
# Reordering (C4)
# ---------------------------------------------------------------------------


def reorder_retrieval(req: RequestContext) -> dict:
    """Apply O2/O3 similarity ordering to the stage's remaining clusters and
    try the O1 cache answer.  Returns a report for benefit accounting."""
    assert req.ret is not None
    cache: LocalCache = req.sim_cache
    report = {"reordered": False, "cache_answer": False, "n_home": 0, "n_probed": 0}
    if cache is None or cache.empty:
        return report
    hit = answer_from_cache(
        cache, req.ret.query_vec, req.ret.k,
        delta=0.15 * float(np.linalg.norm(req.ret.query_vec)),
    )
    if hit is not None:
        d, i = hit
        req.ret.topk = req.ret.topk.merge(d, i)
        req.ret.answered_from_cache = True
        req.ret.cluster_queue = []
        report["cache_answer"] = True
        return report
    plan = reorder_clusters(req.ret.cluster_queue, cache)
    req.ret.cluster_queue = plan.order
    report.update(reordered=True, n_home=plan.n_home, n_probed=plan.n_probed)
    return report


def maybe_early_terminate(index, req: RequestContext,
                          mode: str = "heuristic", patience: int = 3) -> bool:
    """Post-sub-stage termination check (enabled by reordering).
    mode='lossless' uses the triangle-inequality bound (result-preserving);
    mode='heuristic' uses the ANNS patience stop (paper behaviour: earlier
    termination once reordering surfaces good clusters first; recall cost
    measured in benchmarks/bench_similarity.py)."""
    assert req.ret is not None
    if req.ret.done:
        return False
    if mode == "heuristic":
        fire = patience_termination(req.ret.no_improve, len(req.ret.searched),
                                    req.ret.k, patience=patience)
    else:
        fire = early_termination_possible(
            index, req.ret.query_vec, req.ret.cluster_queue, req.ret.topk)
    if fire:
        req.ret.early_terminated = True
        req.ret.cluster_queue = []
        return True
    return False


# ---------------------------------------------------------------------------
# Speculative edge addition (C5)
# ---------------------------------------------------------------------------


def add_speculative_generation(dag: RuntimeDAG, req: RequestContext,
                               basis: SubNode, target_node,
                               target_tokens: int, budget: TimeBudget) -> SubNode:
    """Start the follower Generation node from partial retrieval results.
    The speculative sub-node depends only on the *basis* retrieval sub-node,
    not on the full stage — that is the added edge."""
    from repro_torch.core.runtime import GenProgress

    req.gen = GenProgress(target_tokens=target_tokens,
                          speculative_src=basis.sid,
                          spec_basis=req.ret.topk.ids.copy(),
                          node_id=target_node.node_id)
    sn = split_generation_next(dag, req, budget, speculative=True,
                               deps={basis.sid})
    dag.add_spec_edge(basis, sn)
    return sn


def validate_or_rollback(dag: RuntimeDAG, req: RequestContext,
                         spec: Speculator) -> bool:
    """Dependency rewiring at retrieval completion: if the partial top-k the
    speculative generation consumed equals the final top-k, the speculative
    sub-nodes become the real ones (rewired to depend on the completed
    stage); otherwise they are invalidated and generation restarts."""
    assert req.gen is not None and req.ret is not None
    ok = spec.validate_gen(req.gen.spec_basis, req.ret.topk.ids)
    if ok:
        req.gen.speculative_src = None
        req.gen.spec_basis = None
        for sn in dag.subnodes.values():
            if sn.req is req and sn.kind == "gen":
                sn.speculative = False
        return True
    # rollback: invalidate speculative work, restart the generation stage
    for sn in list(dag.subnodes.values()):
        if sn.req is req and sn.kind == "gen" and sn.speculative:
            dag.invalidate(sn)
    tgt, nid = req.gen.target_tokens, req.gen.node_id
    from repro_torch.core.runtime import GenProgress

    req.gen = GenProgress(target_tokens=tgt, node_id=nid)
    return False

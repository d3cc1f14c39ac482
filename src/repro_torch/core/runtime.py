"""Runtime request state + the sub-node DAG the scheduler transforms.

The static RAGraph unfolds, per request, into a *runtime DAG* of fine-grained
sub-nodes (paper §4.2/§4.5).  Sub-nodes are materialised lazily — the next
slice of a stage is created each scheduling cycle under the current time
budget, which is what makes partitioning "dynamic".  Graph transformations
(transforms.py) mutate this DAG: splitting appends sequentially-dependent
sub-nodes, reordering permutes a retrieval stage's remaining cluster queue,
speculative edges add sub-nodes whose results need validation, and rewiring
re-parents dependants after validation/rollback.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import numpy as np

from repro_torch.core.ragraph import END, Node, RAGraph
from repro_torch.retrieval.ivf import TopK

_sid_counter = itertools.count()


# ---------------------------------------------------------------------------
# Per-stage progress
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GenProgress:
    target_tokens: int  # known in sim mode; cap in real mode
    generated: int = 0
    engine_seq: Optional[Any] = None  # real-engine sequence handle
    prefilled: bool = False
    started_at: float = -1.0
    speculative_src: Optional[str] = None  # sub-node id speculation is based on
    spec_basis: Optional[np.ndarray] = None  # partial top-k ids used to start
    node_id: Optional[int] = None  # generation node this progress belongs to

    @property
    def done(self) -> bool:
        return self.prefilled and self.generated >= self.target_tokens


@dataclasses.dataclass
class RetProgress:
    query_vec: np.ndarray
    cluster_queue: list[int]  # remaining clusters, in (possibly reordered) order
    topk: TopK
    k: int
    nprobe: int
    searched: list[int] = dataclasses.field(default_factory=list)
    answered_from_cache: bool = False
    early_terminated: bool = False
    started_at: float = -1.0
    # adaptive-termination tracking: clusters since the kth distance improved
    no_improve: int = 0
    last_kth: float = float("inf")

    @property
    def done(self) -> bool:
        return (
            self.answered_from_cache
            or self.early_terminated
            or not self.cluster_queue
        )


@dataclasses.dataclass
class StageProgress:
    """Generic host-side stage progress for registry stage kinds beyond the
    paper's original two (rerank / rewrite / compress / ...).  The scheduler
    treats it as an opaque queue of splittable work units; unit semantics
    (candidate blocks, query variants) belong to the owning StageSpec, which
    keeps spec-private state in ``payload``."""

    kind: str
    work_queue: list  # remaining work units, spec-defined granularity
    total_units: int
    payload: dict = dataclasses.field(default_factory=dict)
    started_at: float = -1.0
    inflight_units: int = 0  # units dispatched, not yet completed
    parked: bool = False  # fused subscriber: completed by the leader

    @property
    def done(self) -> bool:
        return not self.work_queue and self.inflight_units == 0


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestContext:
    request_id: int
    graph: RAGraph
    state: dict  # workflow variables ({"input": ..., outputs of nodes, ...})
    arrival_us: float = 0.0
    slo_us: float = 0.0  # per-request latency SLO; 0 -> scheduler default
    # monotonic admission sequence (scheduler-assigned): breaks pending-heap
    # ties at equal arrival stamps in submission order, so concurrent
    # wall-clock submits replay exactly as they ran
    ingress_seq: Optional[int] = None
    current: Optional[int] = None  # active node id; None before START/after END
    finished: bool = False
    finish_us: float = -1.0
    gen: Optional[GenProgress] = None
    ret: Optional[RetProgress] = None
    stage: Optional[StageProgress] = None  # registry stage kinds beyond gen/ret
    round_idx: int = 0  # retrieval round counter (drives embedder)
    gen_round: int = 0
    # similarity cache (core/similarity.py LocalCache) — one per request
    sim_cache: Any = None
    # event log [(t_us, event, payload)] for latency accounting + the journal
    events: list = dataclasses.field(default_factory=list)

    def log(self, t_us: float, event: str, payload=None):
        self.events.append((t_us, event, payload))

    @property
    def node(self) -> Node:
        assert self.current is not None
        return self.graph.nodes[self.current]

    def advance(self) -> bool:
        """Move to the successor node.  Returns False when the request ends."""
        nxt = self.graph.successor(self.current, self.state)
        self.gen, self.ret, self.stage = None, None, None
        if nxt is END:
            self.current = None
            self.finished = True
            return False
        self.current = int(nxt)
        return True

    def start(self) -> None:
        self.current = self.graph.entry()


# ---------------------------------------------------------------------------
# Sub-node DAG
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SubNode:
    sid: str
    req: RequestContext
    node_id: int
    kind: str  # 'gen' | 'ret'
    payload: dict  # gen: {'n_steps': int}; ret: {'clusters': list[int]}
    deps: set = dataclasses.field(default_factory=set)
    speculative: bool = False
    status: str = "ready"  # ready | running | done | invalid
    result: Any = None

    def __hash__(self):
        return hash(self.sid)


class RuntimeDAG:
    """Materialised sub-nodes of all in-flight requests."""

    def __init__(self):
        self.subnodes: dict[str, SubNode] = {}
        self.spec_edges: list[tuple[str, str]] = []  # (basis sub-node, spec sub-node)

    def new_subnode(self, req: RequestContext, kind: str, payload: dict,
                    deps=(), speculative=False) -> SubNode:
        sid = f"{kind}-{req.request_id}-{next(_sid_counter)}"
        sn = SubNode(sid, req, req.current if req.current is not None else -1,
                     kind, payload, set(deps), speculative)
        self.subnodes[sid] = sn
        return sn

    def add_spec_edge(self, basis: SubNode, spec: SubNode) -> None:
        self.spec_edges.append((basis.sid, spec.sid))

    def ready(self) -> list[SubNode]:
        out = []
        for sn in self.subnodes.values():
            if sn.status != "ready":
                continue
            if all(self.subnodes[d].status == "done" for d in sn.deps
                   if d in self.subnodes):
                out.append(sn)
        return out

    def complete(self, sn: SubNode, result=None) -> None:
        sn.status = "done"
        sn.result = result

    def invalidate(self, sn: SubNode) -> None:
        """Speculation rollback: mark a speculative sub-node (and dependants)
        invalid so the scheduler re-materialises the work."""
        sn.status = "invalid"
        for other in self.subnodes.values():
            if sn.sid in other.deps and other.status in ("ready", "running"):
                self.invalidate(other)

    def rewire(self, sn: SubNode, new_deps: set) -> None:
        sn.deps = set(new_deps)

    def gc(self) -> None:
        """Drop sub-nodes of finished requests (journal keeps the history)."""
        dead = [sid for sid, sn in self.subnodes.items() if sn.req.finished]
        for sid in dead:
            del self.subnodes[sid]
        self.spec_edges = [
            (a, b) for a, b in self.spec_edges
            if a in self.subnodes and b in self.subnodes
        ]

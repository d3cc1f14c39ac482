"""RAGraph: the paper's graph abstraction for heterogeneous RAG workflows.

The construction API follows Listing 1 of the paper:

    g = RAGraph()
    g.add_generation(0, prompt="Generate a hypothesis for {input}.",
                     output="hypopara")
    g.add_retrieval(1, topk=5, query="hypopara", output="docs")
    g.add_generation(2, prompt="Answer {query} using {docs}.")
    g.add_edge(START, 0); g.add_edge(0, 1)
    g.add_edge(1, 2); g.add_edge(2, END)
    # conditional control flow:
    g.add_edge(2, lambda s: 1 if s.get("subquestion") else END)

Beyond Listing 1's two node kinds, the node model is *stage-polymorphic*:
each node dataclass here is plain data (id, wiring keys, knobs) tagged with
a ``kind`` string, and everything behavioural — how a stage enters/executes/
splits/finishes, what it costs, how it deduplicates — lives in the matching
``StageSpec`` registered in :mod:`repro_torch.core.stages`.  The scheduler layers
(``core/wavefront.py``, ``serving/dispatch.py``, ``crossreq/dedup.py``)
dispatch through that registry, so new stage types plug in without touching
the scheduler.  Registered kinds:

    generation  open-ended token process on the accelerator (splittable by
                decode steps)
    retrieval   structurally-bounded IVF cluster-scan sequence on the host
                (splittable by cluster; optional dense+lexical hybrid
                fusion via ``lexical_weight``)
    rerank      cross-encoder scoring over retrieved candidates (splittable
                by candidate block)
    rewrite     multi-query expansion fanning out N retrieval sub-searches
                whose results k-way merge through the BatchTopK fold
    compress    extractive context compression by block saliency
                (splittable by candidate block)

Nodes capture the *execution asymmetry* the paper highlights: host-side
stages are bounded unit sequences, generation is open-ended — and every
registered stage declares its splittability, which is what the whole
scheduler exploits (see transforms.py / stages.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union


class _Sentinel:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name


START = _Sentinel("START")
END = _Sentinel("END")

NodeId = int
EdgeTarget = Union[NodeId, _Sentinel, Callable[[dict], Union[NodeId, _Sentinel]]]


@dataclasses.dataclass(frozen=True)
class GenerationNode:
    node_id: NodeId
    prompt: str
    output: str = "answer"
    max_tokens: int = 256
    # declarative knobs the scheduler may use
    emit_partial_embeddings: bool = True  # allow speculative retrieval from it

    kind = "generation"

    def inputs(self) -> list[str]:
        import string

        return [f[1] for f in string.Formatter().parse(self.prompt) if f[1]]


@dataclasses.dataclass(frozen=True)
class RetrievalNode:
    node_id: NodeId
    query: str  # state key holding the query text/embedding source
    output: str = "docs"
    topk: int = 5
    nprobe: int = 0  # 0 -> server default
    # dense+lexical hybrid fusion: weight of the lexical (term-match) score
    # in the reciprocal-rank fusion of the stage's final candidates.  0.0
    # (default) keeps the pure dense path bit-identical to the pre-hybrid
    # behaviour; > 0 rescores the dense top-k with the backend's lexical
    # scorer at stage completion (an instant transform, like reorders).
    lexical_weight: float = 0.0

    kind = "retrieval"

    def inputs(self) -> list[str]:
        return [self.query]


@dataclasses.dataclass(frozen=True)
class RerankNode:
    """Cross-encoder rescoring of retrieved candidates: reads the doc-id
    list at ``docs``, scores every (query, doc) pair with the backend's
    interaction model, keeps the best ``keep``.  Splittable by candidate
    block (``block`` docs per sub-stage unit)."""

    node_id: NodeId
    docs: str  # state key holding the candidate doc-id list
    output: str = "docs"
    keep: int = 5
    block: int = 8  # candidate docs per splittable work unit
    query: str = "input"  # state key whose query embedding anchors scoring

    kind = "rerank"

    def inputs(self) -> list[str]:
        return [self.docs, self.query]


@dataclasses.dataclass(frozen=True)
class RewriteNode:
    """Multi-query expansion: derives ``n_queries`` query variants from the
    request's query embedding, fans out one retrieval sub-search per
    variant, and k-way merges the per-variant top-k sets through the
    ``BatchTopK`` gather fold.  Splittable by variant."""

    node_id: NodeId
    query: str = "input"
    output: str = "docs"
    n_queries: int = 3
    topk: int = 5
    nprobe: int = 0  # 0 -> server default

    kind = "rewrite"

    def inputs(self) -> list[str]:
        return [self.query]


@dataclasses.dataclass(frozen=True)
class CompressNode:
    """Extractive context compression: scores retrieved docs by block
    saliency (training/compression.py's per-block absmax rule) crossed with
    query affinity and keeps the top ``ratio`` fraction.  Splittable by
    candidate block."""

    node_id: NodeId
    docs: str
    output: str = "docs"
    ratio: float = 0.5  # fraction of candidates kept (at least 1)
    block: int = 8
    query: str = "input"

    kind = "compress"

    def inputs(self) -> list[str]:
        return [self.docs, self.query]


Node = Union[GenerationNode, RetrievalNode, RerankNode, RewriteNode,
             CompressNode]


class RAGraph:
    """User-facing workflow graph (static structure; per-request state lives
    in RequestContext)."""

    def __init__(self, name: str = "ragraph"):
        self.name = name
        self.nodes: dict[NodeId, Node] = {}
        self.edges: dict[Any, list[EdgeTarget]] = {}

    # ------------------------------------------------------------ primitives
    def add_node(self, node: Node) -> "RAGraph":
        """Register a pre-built stage node (any kind known to the stage
        registry)."""
        if node.node_id in self.nodes:
            raise ValueError(f"duplicate node id {node.node_id}")
        self.nodes[node.node_id] = node
        return self

    def add_generation(self, node_id: NodeId, prompt: str, output: str = "answer",
                       max_tokens: int = 256, **kw) -> "RAGraph":
        return self.add_node(
            GenerationNode(node_id, prompt, output, max_tokens, **kw))

    def add_retrieval(self, node_id: NodeId, query: str, output: str = "docs",
                      topk: int = 5, nprobe: int = 0, **kw) -> "RAGraph":
        return self.add_node(
            RetrievalNode(node_id, query, output, topk, nprobe, **kw))

    def add_rerank(self, node_id: NodeId, docs: str, output: str = "docs",
                   keep: int = 5, **kw) -> "RAGraph":
        return self.add_node(RerankNode(node_id, docs, output, keep, **kw))

    def add_rewrite(self, node_id: NodeId, query: str = "input",
                    output: str = "docs", n_queries: int = 3,
                    **kw) -> "RAGraph":
        return self.add_node(
            RewriteNode(node_id, query, output, n_queries, **kw))

    def add_compress(self, node_id: NodeId, docs: str, output: str = "docs",
                     ratio: float = 0.5, **kw) -> "RAGraph":
        return self.add_node(CompressNode(node_id, docs, output, ratio, **kw))

    def add_edge(self, src: Union[NodeId, _Sentinel], dst: EdgeTarget) -> "RAGraph":
        self.edges.setdefault(_key(src), []).append(dst)
        return self

    # ------------------------------------------------------------- traversal
    def entry(self) -> NodeId:
        outs = self.edges.get("START", [])
        if not outs:
            raise ValueError("graph has no START edge")
        first = outs[0]
        if callable(first):
            raise ValueError("START edge must be unconditional")
        assert not isinstance(first, _Sentinel)
        return first

    def successor(self, node_id: NodeId, state: dict) -> Union[NodeId, _Sentinel]:
        """Resolve the next node given per-request state (conditional edges
        are evaluated in insertion order; first non-None wins)."""
        for tgt in self.edges.get(_key(node_id), []):
            if callable(tgt):
                r = tgt(state)
                if r is not None:
                    return r
            else:
                return tgt
        return END

    def validate(self) -> None:
        """Static well-formedness checks with actionable errors, run at
        Server admission — malformed graphs fail here instead of deep
        inside the scheduler loop.

        * every edge endpoint names a known node;
        * a START edge exists (and is unconditional — ``entry`` enforces);
        * every node is reachable from START.  Conditional (callable) edges
          cannot be enumerated statically, so a node carrying one is
          treated as potentially reaching any node — no false positives on
          data-dependent loops, at the cost of weaker coverage there;
        * every node has a path onward (at least one outgoing edge — with
          none, ``successor`` would route it straight to END, which is
          almost always a forgotten ``add_edge``);
        * every template input a node declares (``{field}`` in a prompt,
          a query/docs state key) is either the request ``input``, a
          runtime-provided ``_``-prefixed key, or some node's output.
        """
        if "START" not in self.edges:
            raise ValueError(f"graph {self.name!r}: missing START edge")
        for src, dsts in self.edges.items():
            if src not in ("START",) and src not in self.nodes:
                raise ValueError(
                    f"graph {self.name!r}: edge from unknown node {src}")
            for d in dsts:
                if callable(d) or isinstance(d, _Sentinel):
                    continue
                if d not in self.nodes:
                    raise ValueError(
                        f"graph {self.name!r}: edge to unknown node {d}")
        self.entry()
        # reachability from START (callable edges conservatively reach all)
        seen: set = set()
        frontier = ["START"]
        while frontier:
            src = frontier.pop()
            for d in self.edges.get(src, []):
                if callable(d):
                    targets = list(self.nodes)  # cannot enumerate: assume any
                elif isinstance(d, _Sentinel):
                    continue
                else:
                    targets = [d]
                for t in targets:
                    if t not in seen:
                        seen.add(t)
                        frontier.append(t)
        unreachable = sorted(set(self.nodes) - seen)
        if unreachable:
            raise ValueError(
                f"graph {self.name!r}: nodes {unreachable} unreachable from "
                f"START — add an edge into them or remove them")
        # onward paths: a node with no outgoing edge list silently falls to
        # END, which in practice is a forgotten add_edge
        dangling = sorted(n for n in self.nodes
                          if not self.edges.get(_key(n)))
        if dangling:
            raise ValueError(
                f"graph {self.name!r}: nodes {dangling} have no outgoing "
                f"edge — add add_edge(n, END) if termination is intended")
        # dataflow: every declared input must be satisfiable.  "input" is
        # the request text; "query" is Listing 1's builtin alias for it
        produced = {"input", "query"} | {n.output for n in self.nodes.values()}
        for n in self.nodes.values():
            for name in n.inputs():
                if name.startswith("_") or name in produced:
                    continue
                raise ValueError(
                    f"graph {self.name!r}: node {n.node_id} ({n.kind}) "
                    f"reads {name!r}, which no node produces — available "
                    f"keys: {sorted(produced)}")

    # ----------------------------------------------------- interop adapters
    @classmethod
    def from_langchain_steps(cls, steps: list[dict], name: str = "imported") -> "RAGraph":
        """Import a linear LangChain/LlamaIndex-style chain:
        [{"type": "llm"|"retriever", ...kwargs}] -> RAGraph."""
        g = cls(name)
        prev: Union[NodeId, _Sentinel] = START
        for i, s in enumerate(steps):
            if s["type"] in ("llm", "generation"):
                g.add_generation(i, prompt=s.get("prompt", "{input}"),
                                 output=s.get("output", f"gen_{i}"),
                                 max_tokens=s.get("max_tokens", 256))
            elif s["type"] in ("retriever", "retrieval"):
                g.add_retrieval(i, query=s.get("query", "input"),
                                output=s.get("output", f"docs_{i}"),
                                topk=s.get("topk", 5))
            else:
                raise ValueError(f"unknown step type {s['type']}")
            g.add_edge(prev, i)
            prev = i
        g.add_edge(prev, END)
        return g


def _key(x):
    return "START" if x is START else x

"""The paper's five evaluation workflows as RAGraphs (§6.1), plus the
stage-registry workflows built from the polymorphic stage kinds.

Paper five:

  one-shot   retrieve -> generate
  multistep  decompose -> [retrieve -> answer] x subquestions (conditional loop)
  irg        [generate -> retrieve] x N iterative retrieval-generation
  hyde       hypothesis-generate -> retrieve(with hypothesis) -> answer
  recomp     retrieve -> compress(as generation) -> answer

Registry workflows (core/stages.py kinds as first-class graph stages):

  rerank      retrieve wide -> cross-encoder rerank -> generate
  multiquery  rewrite (N query variants, k-way merged) -> generate
  hybrid      dense+lexical retrieval (rrf fusion) -> generate
  compress    retrieve wide -> extractive compress -> generate
  pipeline    rewrite -> rerank -> compress -> generate (all four host kinds)

The conditional loops terminate through per-request state counters, which is
how the paper's Listing 1 lambda edges resolve at runtime.  ``max_rounds``
caps iteration; the workload profile decides the actual per-request rounds
(written into state at admission by the Server).
"""
from __future__ import annotations

from repro_torch.core.ragraph import END, START, RAGraph


def one_shot(topk: int = 5) -> RAGraph:
    g = RAGraph("one-shot")
    g.add_retrieval(0, query="input", output="docs", topk=topk)
    g.add_generation(1, prompt="Answer {input} using {docs}.", output="answer")
    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, END)
    return g


def hyde(topk: int = 5) -> RAGraph:
    g = RAGraph("hyde")
    g.add_generation(0, prompt="Generate a hypothesis for {input}.",
                     output="hypopara", max_tokens=128)
    g.add_retrieval(1, query="hypopara", output="docs", topk=topk)
    g.add_generation(2, prompt="Answer {input} using {docs}.", output="answer")
    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(2, END)
    return g


def recomp(topk: int = 8) -> RAGraph:
    g = RAGraph("recomp")
    g.add_retrieval(0, query="input", output="docs", topk=topk)
    g.add_generation(1, prompt="Compress {docs} for {input}.",
                     output="summary", max_tokens=96)
    g.add_generation(2, prompt="Answer {input} using {summary}.", output="answer")
    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(2, END)
    return g


def multistep(topk: int = 2) -> RAGraph:
    """Decompose into subquestions, answer each with its own retrieval."""
    g = RAGraph("multistep")
    g.add_generation(0, prompt="Decompose {input} into subquestions.",
                     output="subquestion", max_tokens=96)
    g.add_retrieval(1, query="subquestion", output="docs", topk=topk)
    g.add_generation(2, prompt="Answer {subquestion} using {docs}.",
                     output="subanswer")

    def loop(state: dict):
        state["_round"] = state.get("_round", 0) + 1
        return 1 if state["_round"] < state.get("_target_rounds", 2) else END

    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(2, loop)
    return g


def irg(topk: int = 5) -> RAGraph:
    """Iterative retrieval-generation synergy (IRG / ITER-RETGEN)."""
    g = RAGraph("irg")
    g.add_generation(0, prompt="Draft an answer for {input}.",
                     output="draft", max_tokens=128)
    g.add_retrieval(1, query="draft", output="docs", topk=topk)
    g.add_generation(2, prompt="Refine {draft} for {input} using {docs}.",
                     output="draft")

    def loop(state: dict):
        state["_round"] = state.get("_round", 0) + 1
        return 1 if state["_round"] < state.get("_target_rounds", 2) else END

    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(2, loop)
    return g


def rerank(topk: int = 24, keep: int = 5) -> RAGraph:
    """Retrieve a wide candidate set, cross-encoder rerank, answer."""
    g = RAGraph("rerank")
    g.add_retrieval(0, query="input", output="cands", topk=topk)
    g.add_rerank(1, docs="cands", output="docs", keep=keep)
    g.add_generation(2, prompt="Answer {input} using {docs}.", output="answer")
    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(2, END)
    return g


def multiquery(n_queries: int = 3, topk: int = 5) -> RAGraph:
    """Multi-query expansion: N variant searches, k-way merged."""
    g = RAGraph("multiquery")
    g.add_rewrite(0, query="input", output="docs", n_queries=n_queries,
                  topk=topk)
    g.add_generation(1, prompt="Answer {input} using {docs}.", output="answer")
    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, END)
    return g


def hybrid(topk: int = 8, lexical_weight: float = 0.5) -> RAGraph:
    """Dense+lexical hybrid retrieval with reciprocal-rank fusion."""
    g = RAGraph("hybrid")
    g.add_retrieval(0, query="input", output="docs", topk=topk,
                    lexical_weight=lexical_weight)
    g.add_generation(1, prompt="Answer {input} using {docs}.", output="answer")
    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, END)
    return g


def compress(topk: int = 16, ratio: float = 0.5) -> RAGraph:
    """Retrieve wide, extractively compress the context, answer."""
    g = RAGraph("compress")
    g.add_retrieval(0, query="input", output="cands", topk=topk)
    g.add_compress(1, docs="cands", output="docs", ratio=ratio)
    g.add_generation(2, prompt="Answer {input} using {docs}.", output="answer")
    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(2, END)
    return g


def pipeline(n_queries: int = 3, topk: int = 12, keep: int = 8,
             ratio: float = 0.5) -> RAGraph:
    """Every host stage kind in one chain: rewrite -> rerank -> compress ->
    generate (the stress workflow for the heterogeneous mix)."""
    g = RAGraph("pipeline")
    g.add_rewrite(0, query="input", output="cands", n_queries=n_queries,
                  topk=topk)
    g.add_rerank(1, docs="cands", output="picked", keep=keep)
    g.add_compress(2, docs="picked", output="docs", ratio=ratio)
    g.add_generation(3, prompt="Answer {input} using {docs}.", output="answer")
    g.add_edge(START, 0)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    g.add_edge(2, 3)
    g.add_edge(3, END)
    return g


WORKFLOWS = {
    "one-shot": one_shot,
    "hyde": hyde,
    "recomp": recomp,
    "multistep": multistep,
    "irg": irg,
    "rerank": rerank,
    "multiquery": multiquery,
    "hybrid": hybrid,
    "compress": compress,
    "pipeline": pipeline,
}


def build(name: str, **kw) -> RAGraph:
    g = WORKFLOWS[name](**kw)
    g.validate()
    return g

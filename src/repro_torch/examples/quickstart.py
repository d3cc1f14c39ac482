"""Quickstart: the paper's Listing-1 API end to end (sim-time backend).

Builds a synthetic corpus + IVF index, constructs two RAG workflows with the
graph primitives, serves a small batch of requests with the full HedraRAG
runtime, and prints the metrics that matter (latency, speculation, cache).
The JAX package's ``examples/quickstart.py`` on the port: the same corpus,
workflows, arrivals and sim-time charges, so the same timeline.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.core.backends import SimBackend
from repro_torch.core.ragraph import END, START, RAGraph
from repro_torch.retrieval import CorpusConfig, IVFIndex, SyntheticEmbedder, make_corpus
from repro_torch.retrieval.ivf import ClusterCostModel
from repro_torch.server import Server
from repro_torch.serving.workload import poisson_arrivals


def main(argv=None) -> dict:
    """Returns the metrics summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where k-means builds the index: cuda or cpu")
    args = ap.parse_args(argv)
    # --- corpus + index (stands in for Wikipedia + e5 embeddings) ----------
    docs, _, topics = make_corpus(CorpusConfig(n_docs=20_000, dim=64,
                                               n_topics=128, zipf_alpha=1.25))
    index = IVFIndex.build(docs, n_clusters=64, iters=5, device=args.device)
    embedder = SyntheticEmbedder(topics)

    # --- Listing 1: HyDE-style workflow ------------------------------------
    g1 = RAGraph("hyde")
    g1.add_generation(0, prompt="Generate a hypothesis for {input}.",
                      output="hypopara")
    g1.add_retrieval(1, topk=5, query="hypopara", output="docs")
    g1.add_generation(2, prompt="Answer {input} using {docs}.")
    g1.add_edge(START, 0); g1.add_edge(0, 1)
    g1.add_edge(1, 2); g1.add_edge(2, END)

    # --- Listing 1: Multistep-style workflow with a conditional loop -------
    g2 = RAGraph("multistep")
    g2.add_generation(0, prompt="Decompose {input} into subquestions.",
                      output="subquestion")
    g2.add_retrieval(1, topk=2, query="subquestion", output="docs")
    g2.add_generation(2, prompt="Answer {subquestion} using {docs}.")
    g2.add_edge(START, 0); g2.add_edge(0, 1); g2.add_edge(1, 2)

    def loop(s):
        s["_round"] = s.get("_round", 0) + 1
        return 1 if s["_round"] < s.get("_target_rounds", 2) else END

    g2.add_edge(2, loop)

    # --- server -------------------------------------------------------------
    backend = SimBackend(index, embedder,
                         cost_model=ClusterCostModel(fixed_us=150, per_vector_us=8))
    server = Server(index, embedder, mode="hedra", backend=backend, nprobe=16)
    for i, t in enumerate(poisson_arrivals(5.0, 24, seed=1)):
        server.add_request(f"What is RAG? (v{i})", g1 if i % 2 == 0 else g2,
                           arrival_us=t)

    metrics = server.run()
    summary = metrics.summary()
    print("== HedraRAG quickstart ==")
    for k, v in summary.items():
        print(f"  {k:24s} {v}")
    done = server.sched.done[0]
    print("sample request state keys:", sorted(done.state.keys()))
    print("sample retrieved docs:", done.state.get("docs"))
    return summary


if __name__ == "__main__":
    main()

"""Concurrent heterogeneous workflows (paper Fig. 14 scenario as an example),
served through the *streaming* front-end: a sustained open-loop stream mixing
all five workflow types with per-class SLO tiers, submitted mid-run through
the admission layer (bounded in-system queue + deadline-infeasibility
shedding), with the hot cluster cache and speculation on and a mid-run
straggler injection.  The JAX package's
``examples/multi_workflow_concurrent.py`` on the port: the same stream and
sim-time charges, so the same timeline.

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_workflow_concurrent [--device cpu]
"""
import argparse

from repro_torch.core.backends import SimBackend
from repro_torch.retrieval import (
    CorpusConfig,
    HybridRetrievalEngine,
    IVFIndex,
    SyntheticEmbedder,
    make_corpus,
)
from repro_torch.retrieval.ivf import ClusterCostModel
from repro_torch.server import Server
from repro_torch.serving.workload import MIXES, PROFILES

KEYS = ("avg_latency_ms", "p95_latency_ms", "throughput_rps",
        "steady_goodput_rps", "submitted", "shed",
        "spec_gen_attempts", "spec_gen_validated", "early_terms",
        "cache_answers", "straggler_redispatches")


def main(argv=None) -> dict:
    """Returns {mode: metrics summary}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the index and the hot-cluster cache live: cuda or cpu")
    args = ap.parse_args(argv)
    docs, _, topics = make_corpus(CorpusConfig(n_docs=30_000, dim=64,
                                               n_topics=192, zipf_alpha=1.3))
    index = IVFIndex.build(docs, n_clusters=96, iters=5, device=args.device)
    embedder = SyntheticEmbedder(topics, zipf_alpha=1.3)
    mix = MIXES["balanced"]
    workload = mix.profile(PROFILES["hotpotqa"])  # hop-heavy lengths + tiers
    stream = mix.sample(n=60, rate_per_s=8.0)

    out = {}
    for mode in ["async", "hedra"]:
        hybrid = None
        if mode == "hedra":
            hybrid = HybridRetrievalEngine(index, cache_capacity=16,
                                           update_interval=25, device=args.device)
        backend = SimBackend(
            index, embedder, hybrid=hybrid,
            cost_model=ClusterCostModel(fixed_us=150, per_vector_us=8),
            straggler_prob=0.05, straggler_factor=6.0,
        )
        server = Server(index, embedder, mode=mode, backend=backend,
                        nprobe=16, workload=workload,
                        max_pending=48, admission_control=True)
        # open-loop streaming: step the clock to each arrival, then submit
        for item in stream:
            server.step(item.arrival_us)
            server.submit(item.text, item.workflow, arrival_us=item.arrival_us)
        m = server.run().summary()
        out[mode] = m
        print(f"== {mode} ==")
        for k in KEYS:
            print(f"  {k:24s} {m[k]}")
        if hybrid:
            print(f"  hot-cache hit rate       {hybrid.stats()['hit_rate']:.2f}")
    return out


if __name__ == "__main__":
    main()

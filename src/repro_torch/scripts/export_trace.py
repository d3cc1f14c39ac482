"""Capture a Perfetto-compatible trace of a synthetic serving run.

Runs a seeded serving scenario with span tracing (and optionally the
telemetry sampler) enabled and writes the Chrome trace-event JSON — open it
in https://ui.perfetto.dev or ``chrome://tracing``::

    PYTHONPATH=src python -m repro_torch.scripts.export_trace --out trace.json
    PYTHONPATH=src python -m repro_torch.scripts.export_trace --out trace.json \
        --mode hedra --ret-workers 4 --n-requests 40 --fault-seed 3 \
        --metrics-out metrics.json --attribution --device cpu

The index is built by the port's k-means on ``--device`` (the card unless
the CPU is asked for); ``export`` serves over any index.  With
``--fault-seed`` a seeded random FaultPlan (crashes, stalls, transient
failures) is injected so the trace shows hedge duplicates, lost spans,
retry gaps and failover re-dispatch; ``--attribution`` prints the run-level
latency attribution report (components verified to sum to each request's
measured latency).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import workflows
from repro_torch.core.backends import SimBackend
from repro_torch.obs.trace import request_ids_in_trace, validate_trace
from repro_torch.retrieval import CorpusConfig, IVFIndex, SyntheticEmbedder, make_corpus
from repro_torch.retrieval.ivf import ClusterCostModel
from repro_torch.server import Server
from repro_torch.serving.workload import poisson_arrivals

NAMES = ["one-shot", "hyde", "irg", "multistep", "recomp"]
RET_HEAVY = ClusterCostModel(fixed_us=150.0, per_vector_us=8.0,
                             per_query_us=2.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Record a serving run and export a Perfetto trace")
    ap.add_argument("--out", required=True, metavar="PATH",
                    help="trace JSON output path")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="also sample the metrics registry and write its "
                         "JSON snapshot here")
    ap.add_argument("--mode", default="hedra",
                    choices=["hedra", "async", "sequential"])
    ap.add_argument("--ret-workers", type=int, default=4)
    ap.add_argument("--n-requests", type=int, default=20)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--index-sharding", action="store_true")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="inject FaultPlan.random(seed, ...) so the trace "
                         "shows recovery structure")
    ap.add_argument("--attribution", action="store_true",
                    help="print the latency attribution report")
    ap.add_argument("--device", default="cuda",
                    help="where k-means runs: cuda or cpu")
    return ap.parse_args(argv)


def fixture(device="cuda"):
    docs, _, topics = make_corpus(CorpusConfig(
        n_docs=12000, dim=48, n_topics=96, zipf_alpha=1.2, seed=0))
    return IVFIndex.build(docs, 48, iters=4, device=device), SyntheticEmbedder(topics)


def export(index, embedder, args):
    """Serve the seeded scenario of ``args`` over ``index`` and write its
    trace (and metrics snapshot); returns (server, metrics, trace)."""
    fault_plan = None
    if args.fault_seed is not None:
        from repro_torch.serving.faults import FaultPlan

        horizon = args.n_requests / args.rate * 1e6 + 1e6
        fault_plan = FaultPlan.random(args.fault_seed, args.ret_workers,
                                      horizon, transient_prob=0.05)
        print(f"fault plan: {fault_plan.describe()}")
    be = SimBackend(index, embedder, cost_model=RET_HEAVY, seed=0)
    server = Server(index, embedder, mode=args.mode, backend=be, nprobe=12,
                    topk=5, num_ret_workers=args.ret_workers,
                    index_sharding=args.index_sharding,
                    fault_plan=fault_plan, tracing=True,
                    telemetry=args.metrics_out is not None)
    for i, t in enumerate(poisson_arrivals(args.rate, args.n_requests,
                                           seed=5)):
        server.add_request(f"q{i}", workflows.build(NAMES[i % len(NAMES)]),
                           arrival_us=float(t))
    m = server.run()
    trace = server.export_trace(args.out)
    if args.metrics_out:
        server.metrics_snapshot(args.metrics_out)
    return server, m, trace


def main(argv=None) -> int:
    args = parse_args(argv)
    server, m, trace = export(*fixture(args.device), args)
    problems = validate_trace(trace)
    if problems:
        for p in problems[:10]:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    n_ev = len(trace["traceEvents"])
    n_req = len(request_ids_in_trace(trace))
    print(f"served {m.finished} requests; wrote {args.out}: {n_ev} events "
          f"covering {n_req} requests (structurally valid)")
    print("open in https://ui.perfetto.dev or chrome://tracing")
    if args.metrics_out:
        print(f"metrics snapshot written to {args.metrics_out}")
    if args.attribution:
        rep = server.attribution_report()
        print(json.dumps(
            {k: rep[k] for k in ("finished", "totals_us", "fractions",
                                 "means_us", "bottleneck",
                                 "max_rel_residual")},
            indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher: the HedraRAG scheduler over the real generation and
retrieval engines.

    python -m repro_torch.launch.serve --n-requests 8 --workflow one-shot

runs on the card by default (``--device cpu`` runs the plain PyTorch
versions of the kernels on the CPU) and offers every flag of the JAX
package's launcher.  ``--arch`` picks the model family (its reduced config,
as the JAX launcher): every decoder-only arch serves; ``whisper-medium`` is
refused at start-up, since the engine passes no encoder frames.
``--index-sharding`` serves in shard mode (each retrieval worker owns a
contiguous cluster range and its own partition of the device slab) and
``--fault-seed`` injects a seeded ``FaultPlan``.
``--wallclock`` serves through the threaded wall-clock ingress
(``serving/ingress.py``), open-loop or with ``--closed-loop`` clients;
``--replay-check`` records the measured charges on a ``DurationTape``,
replays the arrival trace into a fresh stack (a new engine over the same
params, a new hybrid engine over the same index) and exits nonzero unless
the per-request event fingerprints are equal.  ``--trace-out`` and
``--metrics-out`` write the Perfetto timeline and the metrics snapshot.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.backends import RealBackend
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.retrieval import (
    CorpusConfig,
    HybridRetrievalEngine,
    IVFIndex,
    SyntheticEmbedder,
    make_corpus,
)
from repro_torch.server import Server
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch import workflows


def build_server(engine: GenerationEngine, index: IVFIndex, embedder,
                 hybrid: HybridRetrievalEngine, prompts: Sequence[np.ndarray], *,
                 max_new: int, nprobe: int = 8, ret_workers: int = 1,
                 dispatch: str = "affinity", index_sharding: bool = False,
                 fault_plan=None, cost_model=None, **server_kw) -> Server:
    """``Server`` in hedra mode over ``RealBackend(engine, hybrid=hybrid)``.

    Each generation stage first admits the next pending prompts into the
    engine's free slots, then decodes for real; ``prompts`` are consumed in
    order.  ``index_sharding`` and ``fault_plan`` go to ``Server`` as they
    are (shard mode puts ``hybrid`` in shard mode too), and so does
    ``server_kw``: ``tracing``, ``telemetry``, ``external_heartbeats``,
    ``fault_tolerance``, the cross-request knobs (``global_cache_size``,
    ``dedup_threshold``, ``replication_factor``) and ``workload``.

    ``cost_model`` replaces the ``ClusterCostModel`` that ``RealBackend``
    calibrates by timing host scans.  The scheduler sizes sub-stages and
    orders requests by it, and a ``DurationTape`` does not record it: a
    replay's stack takes the recorded run's, so that both schedule alike.
    """
    # hybrid= always: without it RealBackend would build a default engine
    backend = RealBackend(engine, index, embedder, hybrid=hybrid)
    if cost_model is not None:
        backend.cluster_cost_model = cost_model
    pending = list(prompts)
    orig = backend.gen_duration

    def gen_duration(n_prefill_tokens, batch, n_steps):
        while engine.can_admit() and pending:
            engine.add_sequence(pending.pop(0), max_new=max_new)
        return orig(n_prefill_tokens, batch, n_steps)

    backend.gen_duration = gen_duration
    return Server(index, embedder, mode="hedra", backend=backend, nprobe=nprobe,
                  num_ret_workers=ret_workers, dispatch_policy=dispatch,
                  index_sharding=index_sharding, fault_plan=fault_plan, **server_kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCH_IDS))
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--workflow", default="one-shot",
                    choices=list(workflows.WORKFLOWS))
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--ret-workers", type=int, default=1,
                    help="size of the retrieval worker pool")
    ap.add_argument("--dispatch", default="affinity",
                    choices=["affinity", "least_loaded", "round_robin"],
                    help="retrieval sub-stage placement policy")
    ap.add_argument("--index-sharding", action="store_true",
                    help="distributed IVF retrieval: each worker owns a "
                         "contiguous cluster-range shard; sub-stages "
                         "scatter-gather across the pool")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="inject a seeded random FaultPlan (crashes/stalls/"
                         "transients) and serve through the recovery path")
    ap.add_argument("--fault-crash-frac", type=float, default=0.25,
                    help="fraction of the pool crashed by the fault plan")
    ap.add_argument("--fault-transient-prob", type=float, default=0.05,
                    help="per-dispatch transient failure probability")
    ap.add_argument("--wallclock", action="store_true",
                    help="serve through the threaded wall-clock ingress "
                         "(serving/ingress.py) instead of the batch path; "
                         "arrivals are real producer-thread timestamps")
    ap.add_argument("--speedup", type=float, default=200.0,
                    help="wall->virtual clock compression for --wallclock "
                         "(1 wall ms = speedup virtual ms)")
    ap.add_argument("--closed-loop", type=int, default=0, metavar="CLIENTS",
                    help="with --wallclock: closed-loop load generation with "
                         "this many client threads (submit, wait, think, "
                         "repeat) instead of an open-loop stream")
    ap.add_argument("--replay-check", action="store_true",
                    help="with --wallclock: record the measured backend "
                         "charges on a DurationTape alongside the arrival "
                         "trace, replay both on a fresh server stack over "
                         "the pure virtual clock, and assert bit-identical "
                         "per-request event fingerprints")
    ap.add_argument("--arrivals-out", metavar="PATH", default=None,
                    help="with --wallclock: write the recorded "
                         "arrival/heartbeat trace JSON here")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record spans and write a Chrome trace-event / "
                         "Perfetto JSON timeline here (implies tracing=True)")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="sample the labeled metrics registry and write the "
                         "JSON snapshot (with an embedded Prometheus text "
                         "exposition) here (implies telemetry=True)")
    ap.add_argument("--cache-update-interval", type=int, default=50,
                    help="sub-stages between hot-cluster cache refreshes")
    ap.add_argument("--cache-transit", type=int, default=2,
                    help="sub-stages a staged cluster stays in transit")
    ap.add_argument("--arrival-gap-ms", type=float, default=20.0,
                    help="virtual time between request arrivals (batch path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    if cfg.is_encoder_decoder:
        ap.error(f"--arch {args.arch} is an encoder-decoder model: the generation engine "
                 "passes no encoder frames, so it serves only decoder-only archs")

    device = resolve_device(args.device)
    fault_plan = None
    if args.fault_seed is not None:
        horizon = args.n_requests * 20_000.0 + 400_000.0
        fault_plan = FaultPlan.random(
            args.fault_seed, args.ret_workers, horizon,
            crash_frac=args.fault_crash_frac,
            transient_prob=args.fault_transient_prob)
        print(f"fault plan: {fault_plan.describe()}")
    docs, _, topics = make_corpus(CorpusConfig(n_docs=8000, dim=48, n_topics=64))
    params = lm.init_params(cfg, seed=0, device=device)
    index = IVFIndex.build(docs, n_clusters=32, iters=4, device=device)
    texts = [f"query {i}" for i in range(args.n_requests)]
    prompts = [(np.frombuffer(t.encode(), np.uint8).astype(np.int32)
                % (cfg.vocab_size - 2)) + 1 for t in texts]

    def make_server(cost_model=None) -> Server:
        # a fresh stack for each serving pass (the replay check needs one:
        # a run changes the engine's KV state and the hot-cluster cache);
        # the params and the index are shared, a run does not change them
        hybrid = HybridRetrievalEngine(index, cache_capacity=8,
                                       update_interval=args.cache_update_interval,
                                       transit_substages=args.cache_transit,
                                       device=device)
        engine = GenerationEngine(cfg, params, max_batch=8, max_len=160, eos_id=0,
                                  device=device)
        return build_server(engine, index, SyntheticEmbedder(topics), hybrid, prompts,
                            max_new=args.max_new, ret_workers=args.ret_workers,
                            dispatch=args.dispatch, index_sharding=args.index_sharding,
                            fault_plan=fault_plan, cost_model=cost_model,
                            external_heartbeats=args.wallclock,
                            fault_tolerance=args.wallclock,
                            tracing=args.trace_out is not None,
                            telemetry=args.metrics_out is not None)

    server = make_server()
    t0 = time.perf_counter()
    if args.wallclock:
        from repro_torch.serving import ingress
        from repro_torch.serving.workload import ClosedLoopSpec, MixSpec

        tape = None
        if args.replay_check:
            # RealBackend charges measured durations, so the arrival trace
            # alone cannot reproduce its timeline: tape the charges too and
            # replay them verbatim into the fresh stack
            tape = ingress.DurationTape()
            ingress.tape_backend(server.backend, tape, mode="record")
        if args.closed_loop > 0:
            spec = ClosedLoopSpec(
                name=args.workflow, weights={args.workflow: 1.0},
                num_clients=args.closed_loop,
                requests_per_client=max(1, args.n_requests // args.closed_loop))
            m, trace = server.serve_wallclock(closed_loop=spec, speedup=args.speedup)
        else:
            mix = MixSpec(args.workflow, weights={args.workflow: 1.0})
            stream = mix.sample(args.n_requests, rate_per_s=50.0)
            m, trace = server.serve_wallclock(stream, speedup=args.speedup)
        print(f"ingress trace: {len(trace.rows)} rows")
        if args.arrivals_out:
            trace.save(args.arrivals_out)
            print(f"arrival trace written to {args.arrivals_out}")
        if args.replay_check:
            replica = make_server(cost_model=server.backend.cluster_cost_model)
            ingress.tape_backend(replica.backend, tape, mode="replay")
            ingress.replay_trace(replica, trace)
            if replica.fingerprints() != server.fingerprints():
                raise SystemExit("replay-check FAILED: virtual-clock replay "
                                 "diverged from the wall-clock run")
            print(f"replay-check ok: virtual-clock replay is bit-identical "
                  f"({len(tape.rows)} taped backend charges, "
                  f"{tape.remaining()} unconsumed)")
    else:
        for i, text in enumerate(texts):
            server.add_request(text, workflows.build(args.workflow),
                               arrival_us=i * args.arrival_gap_ms * 1e3)
        m = server.run()
    print(f"served {m.finished} requests in {time.perf_counter()-t0:.2f}s wall "
          f"on {device}")
    for k, v in m.summary().items():
        print(f"  {k:24s} {v}")
    if args.trace_out:
        server.export_trace(args.trace_out)
        print(f"trace written to {args.trace_out} "
              "(open in https://ui.perfetto.dev or chrome://tracing)")
    if args.metrics_out:
        server.metrics_snapshot(args.metrics_out)
        print(f"metrics snapshot written to {args.metrics_out}")
    return m


if __name__ == "__main__":
    main()

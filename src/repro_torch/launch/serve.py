"""Serving launcher: the HedraRAG scheduler over the real generation and
retrieval engines, batch path.

    python -m repro_torch.launch.serve --n-requests 8 --workflow one-shot

runs on the card by default (``--device cpu`` runs the plain PyTorch
versions of the kernels on the CPU).  ``--index-sharding`` serves in shard
mode (each retrieval worker owns a contiguous cluster range and its own
partition of the device slab) and ``--fault-seed`` injects a seeded
``FaultPlan``.  The launcher of the JAX package also offers
``--wallclock``/``--closed-loop``/``--replay-check`` (wall-clock ingress),
``--trace-out`` and ``--metrics-out``; their modules are not ported yet
(ROADMAP.md queue A).
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
                 fault_plan=None) -> Server:
    """``Server`` in hedra mode over ``RealBackend(engine, hybrid=hybrid)``.

    Each generation stage first admits the next pending prompts into the
    engine's free slots, then decodes for real; ``prompts`` are consumed in
    order.  ``index_sharding`` and ``fault_plan`` go to ``Server`` as they
    are (shard mode puts ``hybrid`` in shard mode too).
    """
    # hybrid= always: without it RealBackend would build a default engine
    backend = RealBackend(engine, index, embedder, hybrid=hybrid)
    pending = list(prompts)
    orig = backend.gen_duration

    def gen_duration(n_prefill_tokens, batch, n_steps):
        while engine.can_admit() and pending:
            engine.add_sequence(pending.pop(0), max_new=max_new)
        return orig(n_prefill_tokens, batch, n_steps)

    backend.gen_duration = gen_duration
    return Server(index, embedder, mode="hedra", backend=backend, nprobe=nprobe,
                  num_ret_workers=ret_workers, dispatch_policy=dispatch,
                  index_sharding=index_sharding, fault_plan=fault_plan)


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
    ap.add_argument("--cache-update-interval", type=int, default=50,
                    help="sub-stages between hot-cluster cache refreshes")
    ap.add_argument("--cache-transit", type=int, default=2,
                    help="sub-stages a staged cluster stays in transit")
    ap.add_argument("--arrival-gap-ms", type=float, default=20.0,
                    help="virtual time between request arrivals")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

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
    cfg = get_config(args.arch).reduced()
    params = lm.init_params(cfg, seed=0, device=device)

    index = IVFIndex.build(docs, n_clusters=32, iters=4, device=device)
    hybrid = HybridRetrievalEngine(index, cache_capacity=8,
                                   update_interval=args.cache_update_interval,
                                   transit_substages=args.cache_transit,
                                   device=device)
    engine = GenerationEngine(cfg, params, max_batch=8, max_len=160, eos_id=0,
                              device=device)
    texts = [f"query {i}" for i in range(args.n_requests)]
    prompts = [(np.frombuffer(t.encode(), np.uint8).astype(np.int32)
                % (cfg.vocab_size - 2)) + 1 for t in texts]
    server = build_server(engine, index, SyntheticEmbedder(topics), hybrid, prompts,
                          max_new=args.max_new, ret_workers=args.ret_workers,
                          dispatch=args.dispatch, index_sharding=args.index_sharding,
                          fault_plan=fault_plan)
    t0 = time.perf_counter()
    for i, text in enumerate(texts):
        server.add_request(text, workflows.build(args.workflow),
                           arrival_us=i * args.arrival_gap_ms * 1e3)
    m = server.run()
    print(f"served {m.finished} requests in {time.perf_counter()-t0:.2f}s wall "
          f"on {device}")
    for k, v in m.summary().items():
        print(f"  {k:24s} {v}")
    return m


if __name__ == "__main__":
    main()

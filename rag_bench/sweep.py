#!/usr/bin/env python3
"""Find an open-loop cell's knee: its stack built once, one window at each
of several rates, each printing the offered and completed rates, the
latency median and tail, and how long the backlog took to drain.

    python3 rag_bench/sweep.py --workload <cell> --seed <n> --seconds 30 --rates 1,2,3,4

A rate is sustained where its window ends without a growing backlog: the
median latency of the requests due in the window's second half is not above
that of the first half's (``sustained`` in its line).  The knee is the
highest rate swept that is sustained, as is every lower rate swept; the
cell's ``rate_rps`` is four fifths of it.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys

from run import DRAIN_S, ROOT, SERVING_KERNELS, load_spec, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True, help="comma-separated req/s")
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from rag_bench.harness import serve
    from rag_bench.harness.stats import latencies, percentile
    from repro_torch.kernels import _build

    _build.build(SERVING_KERNELS)
    dev = torch.device("cuda", 0)
    stack = serve.Stack(torch, dev, spec["config"], spec["mix"], args.seed, req_block=4096,
                        log=log)
    stack.warm_up(stack.widths())
    for rate in (float(r) for r in args.rates.split(",")):
        server = stack.build_server()
        n0, s0 = len(stack.steps), len(stack.admits)
        w = serve.run_open(stack, server, rate, args.seconds, DRAIN_S, lambda t0: None)
        lat, failed = latencies(w)
        half = w.t0 + w.seconds / 2
        early = [w.done.get(t, w.drained_at) - d for t, d in w.due.items() if d < half]
        late = [w.done.get(t, w.drained_at) - d for t, d in w.due.items() if d >= half]
        steps = stack.steps[n0:]
        p50_early, p50_late = percentile(early, 50), percentile(late, 50)
        end = w.t0 + w.seconds
        log(json.dumps({
            "rate_rps": rate, "attempted": len(w.due), "unfinished": failed,
            "completed_rps_in_window": sum(t <= end for t in w.done.values()) / w.seconds,
            "p50_ms": 1e3 * percentile(lat, 50), "p95_ms": 1e3 * percentile(lat, 95),
            "max_ms": 1e3 * max(lat), "drain_s": w.drained_at - w.t0 - w.seconds,
            "p50_ms_first_half": 1e3 * p50_early, "p50_ms_second_half": 1e3 * p50_late,
            "sustained": bool(p50_late <= p50_early),
            "decode_steps": len(steps), "admissions": len(stack.admits) - s0,
            "mean_batch": sum(len(c) for _, _, c in steps) / max(len(steps), 1),
            "timed_out": w.timed_out}))
        while stack.engine.seqs:
            stack.engine.step_batch(64)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 rag_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The cell is an entry of ``workloads`` in ``BENCHMARK.json``;
it names a configuration (``configs/<config>.json``), a traffic mix
(``traffic/<mix>.json``), and has a file of its own (``cells/<cell>.json``:
its rate, and the limits of its check).  Each metric has a
reader in ``metrics/``.  The run:

1. set-up (``setup_s``): builds the port's CUDA kernels into the checkout's
   ``build/kernels`` (only the first run in a checkout compiles), makes the
   weights and the corpus on the card from ``--seed``, builds the IVF index,
   the hybrid retrieval engine and the generation engine (its decode step
   captured as a CUDA graph), and warms up: one admission at each padded
   width the mix uses (capturing its graph), then the mix's warm-up requests
   through the server on the virtual clock;
2. the window: ``--seconds`` of open-loop arrivals at the cell's rate,
   through the wall-clock ingress at speedup 1, then a drain of at most
   60 s; with ``--trace 1`` a profiler over a fixed sub-window;
3. the check (``harness/check.py``), after the peak memory is read and the
   program's state is freed: served tokens, retrieval answers (each
   cluster's and each sub-stage's merge) and queries, and completion
   against the plain reference in ``reference/``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: every number compared beside its
limit); the last lines of standard error repeat the checks.  Without a CUDA
card, or with fewer than the cell asks for, it exits 3 and prints no result;
where the port (``src/repro_torch``) is missing, 2; where ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the window has closed,
4.  ``BENCH_RUN`` in the environment is ignored.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0
SERVING_KERNELS = ("ivf_scan", "decode_attention", "norm", "qk_rope", "glu")


def log(*a):
    print(*a, flush=True)


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration, mix and cell files, and the
    benchmark's metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {
        "bench": bench,
        "cell": cell,
        "config": json.loads((root / cfg_entry["file"]).read_text()),
        "mix": json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text()),
        "cellfile": json.loads((BENCH_DIR / "cells" / f"{workload}.json").read_text()),
    }


def metric_entries(spec: dict, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` 0) or per-layer metrics (1)."""
    entries = spec["bench"]["per_layer" if trace else "end_to_end"]
    name = spec["cell"]["name"]
    return [m for m in entries if "workloads" not in m or name in m["workloads"]]


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules``) whose top-level name is jax, jaxlib,
    flax or repro (compared whole: ``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(torch, dev, spec: dict, seed: int, seconds: float, trace: bool, *,
             tiny: bool = False, fault=None, controls: dict | None = None, out=log) -> dict:
    """One run of a cell.  Returns {"result": the result line's object,
    "numbers": every number the check read, "info": earlier lines}.
    ``fault(stack)`` breaks the timed path after set-up (the tests);
    ``controls`` ({"gen": ("fp8",), "ret": "bf16"}) also reads the control's
    numbers (``control.py``), and "control" in the returned dict is the
    control's verdict by the cell's limits, as ``result`` is the
    program's."""
    from rag_bench.harness import check as chk
    from rag_bench.harness import serve
    from rag_bench.harness import traffic as tr
    from rag_bench.harness.peaks import ModelFlops
    from rag_bench.harness.readings import Context, reader
    from rag_bench.harness.stats import latencies, percentile
    from rag_bench.harness.trace import Profiler
    from rag_bench.reference.ivf import partition_problems, scan_topk
    from repro_torch.kernels import wrappers

    cell, mix, cellfile = spec["cell"], spec["mix"], spec["cellfile"]
    rate = float(cellfile["rate_rps"])
    if tiny:
        rate *= serve.TINY_DEPLOY["rate_scale"]
    # the window's requests: one block, so that every seed serves the same ones
    block = max(1, round(rate * seconds))
    stack = serve.Stack(torch, dev, spec["config"], mix, seed, req_block=block, tiny=tiny,
                        log=out)
    stack.warm_up(stack.widths())
    if fault is not None:
        fault(stack)
    server = stack.build_server()
    kern = {n: w for n, w in wrappers().items() if n in SERVING_KERNELS}
    for w in kern.values():
        w.launches = w.plain_calls = 0
    stats0 = stack.hybrid.stats()
    graphs0 = {w for w, b in stack.engine._prefills.items() if b.graph is not None}
    unhook = None
    if trace:
        unhook = stack._hook_scan()
    # the profiler's sub-window is placed once the window's origin is known
    state = {"prof": None}

    def on_tick(t0):
        if trace and state["prof"] is None:
            state["prof"] = Profiler(torch, stack.spans, t0, seconds)
        if state["prof"] is not None:
            state["prof"].tick()

    try:
        window = serve.run_open(stack, server, rate, seconds, DRAIN_S, on_tick)
    finally:
        prof = state["prof"]
        if prof is not None:
            prof.close()
        if unhook is not None:
            unhook()
    setup_s = window.t0 - T_START
    stats1 = stack.hybrid.stats()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    launches = {n: w.launches for n, w in kern.items()}
    plain = {n: w.plain_calls for n, w in kern.items()}
    captured_in_window = sorted({w for w, b in stack.engine._prefills.items()
                                 if b.graph is not None} - graphs0)
    traced = prof.read() if prof is not None else None
    trace_line = ("trace: " + ("none opened" if prof is None else
                  f"{prof.attempts} attempt(s), " + (
                      "no device operation traced" if traced is None else
                      f"{traced['window_s']:.3f} s traced, device busy {traced['busy_s']:.3f} s"))
                  ) if trace else None
    ctx = Context(window, setup_s, stack,
                  ModelFlops(stack.cfg_view),
                  (stats1["hits"] - stats0["hits"], stats1["misses"] - stats0["misses"]),
                  traced, (prof.opened, prof.closed) if traced is not None else (0.0, 0.0))
    metrics = {}
    for m in metric_entries(spec, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    lags = [window.put[t] - window.due[t] for t in window.due if t in window.put]
    _, failed = latencies(window)
    attempted = len(window.due)
    info = [
        f"window: {seconds} s from set-up's end ({setup_s:.3f} s), drained "
        f"{window.drained_at - window.t0 - seconds:.3f} s after it"
        f"{' (timed out)' if window.timed_out else ''}; {attempted} requests attempted, "
        f"{failed} unfinished",
        f"engine: {len(ctx.decode_steps())} decode steps and {len(ctx.admissions())} admissions "
        f"in the window; generation rounds {stack.gen_rounds}, of which {stack.short_rounds} "
        f"found fewer engine sequences than the scheduler's batch",
        f"prefill graphs captured inside the window: {captured_in_window or 'none'}",
        f"kernel launches in the window and drain {launches}; plain-version calls {plain}",
        f"hot-cluster cache over the window: hits {ctx.cache_delta[0]}, misses "
        f"{ctx.cache_delta[1]}; retrieval sub-stages {len(ctx.durations('ret'))}",
        f"memory_peak_bytes {peak}",
        f"ingress: arrivals put late by p95 {1e3 * percentile(lags, 95):.3f} ms, max "
        f"{1e3 * max(lags, default=float('nan')):.3f} ms",
    ] + ([trace_line] if trace_line else [])
    for line in info:
        out(line)

    # ---- the check, with the program's state freed -----------------------
    sample = chk.gen_sample(stack.records, window.t0, seed)
    items = chk.ret_sample(stack.ret, window.t0, seed)
    groups = chk.group_sample(stack.ret, window.t0, seed)
    # the reference's own embedder: the same arithmetic, not the program's object
    embedder = tr.Embedder(stack.topics, stack.pools.topic, seed)
    problems = partition_problems(stack.index.ids, stack.index.offsets, len(stack.docs))
    for rec in sample:
        problems += chk.row_problems(rec)
    for p in problems:
        out(f"check: {p}")
    numbers = {"unfinished": failed, "partition": len(problems),
               "ret_query": chk.query_problems(groups, embedder)}
    del server
    stack.engine = stack.hybrid = None
    stack.records = stack.ret = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    controls = controls or {}
    numbers.update(chk.gen_numbers(torch, dev, stack.params, stack.cfg_view, sample,
                                   controls.get("gen", ())))
    numbers.update(chk.ret_numbers(items, stack.index.ids, stack.index.offsets, stack.docs,
                                   groups=groups, embedder=embedder))
    if "ret" in controls:
        p = controls["ret"]
        ctl = chk.ret_numbers(items, stack.index.ids, stack.index.offsets, stack.docs,
                              answer=lambda q, m, v, k: scan_topk(q, m, v, k, p),
                              groups=groups, embedder=embedder)
        numbers.update({f"{k}.{p}": v for k, v in ctl.items() if k.startswith("ret_") and
                        k.endswith("err")})
    out(f"check: {len(sample)} sequences ({numbers['gen_tokens']} served tokens), "
        f"{len(items)} retrieval items ({numbers['ret_device_items']} device path, "
        f"{numbers['ret_host_items']} host path) and {numbers['ret_groups']} sub-stage "
        f"merges against the reference in {time.monotonic() - t0:.1f} s")
    correct, shown = chk.judge(numbers, cellfile["limits"])
    if numbers["gen_tokens"] == 0 or not items or not groups:
        correct = False
        out("check: nothing to compare (no finished sequence, retrieval item or merge)")
    control = None
    if controls:  # the control in the program's place, judged by the same limits
        gen_p = controls["gen"][0] if controls.get("gen") else None
        control = chk.judge(chk.control_numbers(numbers, gen_p, controls.get("ret")),
                            cellfile["limits"])
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    if trace:
        if traced is not None:
            result["device"]["busy_s"] = traced["busy_s"]
            result["device"]["window_s"] = traced["window_s"]
            ops = sorted(traced["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
            result["breakdown"] = {"device_ops": [[n[:160], s] for n, (s, _) in ops],
                                   "idle_gaps": [[n, s] for n, s in traced["gaps"]]}
    result["checks"] = shown
    return {"result": result, "numbers": numbers, "info": info, "control": control}


def power_line() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout.strip() \
            else f"nvidia-smi failed: {p.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = load_spec(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"rag_bench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rag_bench: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("rag_bench: the port src/repro_torch is missing from this checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {power_line()}")
    took = _build.build(SERVING_KERNELS)
    log(f"kernels: {', '.join(f'{n} {s:.1f}s' for n, s in took.items())} "
        f"(0.0: already built) in {_build.BUILD_DIR}")
    run = run_cell(torch, dev, spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"rag_bench: loaded in the measuring process: {bad}", file=sys.stderr)
        return 4
    result = run["result"]
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Read the numbers the check compares, for the program and for its control,
on several seeds: what each limit in ``cells/<cell>.json`` is set from.

    python3 rag_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10

Each seed is one run of the cell as ``run.py`` makes it (set-up, a window at
the cell's own load, the check), in one process.  Beside the program's
numbers it prints the control's: the reference put in the program's place
in the precision below the configuration's, on the same prompts, served
tokens and retrieval items: ``gen_gap.fp8`` (at each position the token a
float8 e4m3 forward puts first, read in the f32 reference: the gap below
the best) and ``ret_dist_err.bf16`` / ``ret_rank_err.bf16`` (the scan in
bfloat16).  Beside them, as a witness, ``gen_gap.bf16``: the same reading of
a forward whose matmul operands are rounded to bfloat16, the configuration's
own precision.  The control is judged as the program is, by the cell's
limits, with its numbers in the program's place (``check.control_numbers``):
``control_correct`` has to read false.  The benchmark's own runs never run
the control.  One JSON line a seed; it exits 1 where the program came out
not correct or the control correct on any seed.  It needs the card the cell
asks for.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from run import ROOT, SERVING_KERNELS, load_spec, log, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.kernels import _build

    _build.build(SERVING_KERNELS)
    dev = torch.device("cuda", 0)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        run = run_cell(torch, dev, spec, seed, args.seconds, False,
                       controls={"gen": ("fp8", "bf16"), "ret": "bf16"}, out=lambda *a: None)
        control_correct, control_checks = run["control"]
        line = {"workload": args.workload, "seed": seed, "correct": run["result"]["correct"],
                "control_correct": control_correct,
                "metrics": {k: v["value"] for k, v in run["result"]["metrics"].items()},
                "numbers": run["numbers"], "control_checks": control_checks}
        log(json.dumps(line))
        if control_correct or not run["result"]["correct"]:
            rc = 1
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return rc


if __name__ == "__main__":
    sys.exit(main())

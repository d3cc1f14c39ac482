"""Run the dry-run sweep (all arch x shape x mesh cells), one cell per
process (``launch.dryrun.run_cell_subprocess``: the fake group is
process-wide).

Writes <out-dir>/<arch>.<shape>.<mesh>.json per cell plus a combined
<out-dir>/all.json.  Resumable: existing cell files are skipped unless
--force.  Order: cheap cells first so partial results are useful early.

    PYTHONPATH=src python -m repro_torch.scripts.run_dryrun_all --out-dir results/dryrun
"""
import argparse
import json
import os
import time

from repro_torch.launch.dryrun import run_cell_subprocess

SHAPE_ORDER = ["train_4k", "decode_32k", "long_500k", "prefill_32k"]
# cheap-first arch order (by rough param count)
ARCH_ORDER = [
    "qwen3-1.7b", "rwkv6-1.6b", "recurrentgemma-2b", "paligemma-3b",
    "phi3-mini-3.8b", "whisper-medium", "stablelm-12b",
    "deepseek-v2-lite-16b", "llama4-scout-17b-a16e", "qwen1.5-110b",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--archs", default="", help="comma list; default all")
    ap.add_argument("--shapes", default="", help="comma list; default all")
    ap.add_argument("--train-microbatch", type=int, default=0,
                    help="gradient-accumulation slices for train cells")
    ap.add_argument("--decode-layout", default="tp",
                    choices=["tp", "serve_tp", "dp_only"])
    ap.add_argument("--device-type", default=None, choices=[None, "cpu", "cuda"])
    ap.add_argument("--timeout", type=float, default=3600.0, help="seconds a cell")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    archs = args.archs.split(",") if args.archs else ARCH_ORDER
    shapes = args.shapes.split(",") if args.shapes else SHAPE_ORDER
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t_start = time.time()
    n_done = 0
    for shape in shapes:
        for arch in archs:
            for mk in meshes:
                path = os.path.join(args.out_dir, f"{arch}.{shape}.{mk}.json")
                if os.path.exists(path) and not args.force:
                    continue
                kind = ("train" if shape.startswith("train") else
                        "decode" if shape in ("decode_32k", "long_500k") else
                        "prefill")
                mb = args.train_microbatch if kind == "train" else 0
                layout = args.decode_layout if kind == "decode" else "tp"
                t0 = time.time()
                rec = run_cell_subprocess(arch, shape, mk, microbatch=mb, layout=layout,
                                          device_type=args.device_type,
                                          timeout=args.timeout)
                rec["wall_s"] = time.time() - t0
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=str)
                n_done += 1
                status = ("SKIP" if not rec.get("applicable", True)
                          else "ERR " if "error" in rec else "ok  ")
                dom = rec.get("roofline", {}).get("dominant", "-")
                print(f"[{time.time()-t_start:7.0f}s] {status} {arch:24s} "
                      f"{shape:12s} {mk:6s} {rec['wall_s']:6.1f}s dom={dom}",
                      flush=True)

    # combined file
    allrecs = []
    for fn in sorted(os.listdir(args.out_dir)):
        if fn.endswith(".json") and fn != "all.json":
            with open(os.path.join(args.out_dir, fn)) as f:
                allrecs.append(json.load(f))
    with open(os.path.join(args.out_dir, "all.json"), "w") as f:
        json.dump(allrecs, f, indent=2, default=str)
    print(f"DONE: {n_done} cells in {time.time()-t_start:.0f}s")


if __name__ == "__main__":
    main()

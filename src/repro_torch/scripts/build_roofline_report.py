"""Build the dry-run / roofline tables from a directory of dry-run records
(``run_dryrun_all``'s output).

    PYTHONPATH=src python -m repro_torch.scripts.build_roofline_report results/dryrun

The bounds are the H100 SXM5 80GB HBM3 (700 W) data sheet's figures
(``analysis.costs``), not measurements.
"""
import json
import os
import sys

from repro_torch.analysis.costs import HBM_BYTES, PEAK_FLOPS_BF16

ARCHS = [
    "rwkv6-1.6b", "stablelm-12b", "qwen3-1.7b", "phi3-mini-3.8b",
    "qwen1.5-110b", "recurrentgemma-2b", "whisper-medium",
    "deepseek-v2-lite-16b", "llama4-scout-17b-a16e", "paligemma-3b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir, arch, shape, mesh):
    p = os.path.join(out_dir, f"{arch}.{shape}.{mesh}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def fmt_t(x):
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else "results/dryrun"
    hbm_gb = HBM_BYTES / 1e9
    rows = []
    print("## Roofline table (single mesh: data=32 x model=8 = 256 H100s)\n")
    print("| arch | shape | status | t_compute | t_memory | t_coll | dominant "
          f"| useful/traced | peak GB/dev | fits {hbm_gb:.0f}GB | multi-pod |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for arch in ARCHS:
        for shape in SHAPES:
            r = load(out_dir, arch, shape, "single")
            m = load(out_dir, arch, shape, "multi")
            if r is None:
                print(f"| {arch} | {shape} | MISSING | | | | | | | | |")
                continue
            if not r.get("applicable", True):
                print(f"| {arch} | {shape} | SKIP ({r['reason'][:40]}) | | | | | | | | "
                      f"{'skip' if m is None or not m.get('applicable', True) else 'ok'} |")
                continue
            if "error" in r:
                print(f"| {arch} | {shape} | ERROR {r['error'][:40]} | | | | | | | | |")
                continue
            rf = r["roofline"]
            mem = r["memory"]["peak_bytes_est"] / 1e9
            fits = "yes" if mem <= hbm_gb else "NO"
            multi_ok = "ok" if (m and "error" not in m and m.get("memory")) else (
                "ERR" if m else "MISSING")
            print(f"| {arch} | {shape} | ok ({r['compile_s']:.0f}s) "
                  f"| {fmt_t(rf['t_compute_s'])} | {fmt_t(rf['t_memory_s'])} "
                  f"| {fmt_t(rf['t_collective_s'])} | **{rf['dominant']}** "
                  f"| {rf['useful_flops_ratio']:.2f} | {mem:.1f} | {fits} | {multi_ok} |")
            rows.append((arch, shape, rf))
    print("\n## Hillclimb candidates\n")
    scored = []
    for arch, shape, rf in rows:
        terms = {"compute": rf["t_compute_s"], "memory": rf["t_memory_s"],
                 "collective": rf["t_collective_s"]}
        dom = rf["dominant"]
        tot = sum(terms.values())
        # roofline fraction: useful compute time / dominant term
        useful_t = rf["flops_per_device"] * rf["useful_flops_ratio"] / PEAK_FLOPS_BF16
        frac = useful_t / max(terms[dom], 1e-12)
        coll_share = terms["collective"] / max(tot, 1e-12)
        scored.append((frac, coll_share, arch, shape, dom))
    scored.sort()
    print("worst roofline fraction:")
    for frac, cs, arch, shape, dom in scored[:5]:
        print(f"  {arch} {shape}: frac={frac:.3f} dom={dom} coll_share={cs:.2f}")
    print("most collective-bound:")
    for frac, cs, arch, shape, dom in sorted(scored, key=lambda x: -x[1])[:5]:
        print(f"  {arch} {shape}: coll_share={cs:.2f} frac={frac:.3f} dom={dom}")


if __name__ == "__main__":
    main()

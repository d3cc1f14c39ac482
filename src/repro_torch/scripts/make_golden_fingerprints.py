"""Per-request event-trace hashes of the five paper workflows across
scheduler modes and worker counts, written to a JSON file::

    PYTHONPATH=src python -m repro_torch.scripts.make_golden_fingerprints \
        --out fingerprints.json [--device cpu]

The hashes pin the serving loop's observable behaviour: a refactor of the
stage or scheduler layers must keep every (mode, num_ret_workers) trace
bit-identical.  Everything is seeded (synthetic corpus, k-means, workload
lengths, Poisson arrivals, backend noise).  The index is built by the
port's k-means on ``--device`` (the card unless the CPU is asked for), so
the hashes are those of the port's index; ``fingerprints`` takes any index.
The output path is required, and the repository's own
``tests/golden_fingerprints.json`` is refused: those hashes belong to the
reference package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

from repro_torch import workflows
from repro_torch.core.backends import SimBackend
from repro_torch.retrieval import CorpusConfig, IVFIndex, SyntheticEmbedder, make_corpus
from repro_torch.retrieval.ivf import ClusterCostModel
from repro_torch.server import Server
from repro_torch.serving.workload import poisson_arrivals

NAMES = ["one-shot", "hyde", "irg", "multistep", "recomp"]
RET_HEAVY = ClusterCostModel(fixed_us=150.0, per_vector_us=8.0, per_query_us=2.0)
MODES = ["hedra", "async", "sequential"]
WORKERS = [1, 4]
GOLDENS = Path(__file__).resolve().parents[3] / "tests" / "golden_fingerprints.json"


def fixture(device="cuda"):
    docs, _, topics = make_corpus(CorpusConfig(
        n_docs=12000, dim=48, n_topics=96, zipf_alpha=1.2, seed=0))
    return IVFIndex.build(docs, 48, iters=4, device=device), SyntheticEmbedder(topics)


def trace_hash(server) -> str:
    fp = {
        r.request_id: [(float(t), e, repr(p)) for t, e, p in r.events]
        for r in server.sched.done
    }
    blob = json.dumps(fp, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def fingerprints(index, emb) -> dict[str, str]:
    """``{"<mode>-nw<workers>": hash}`` of 20 Poisson arrivals (8/s) served
    over ``SimBackend`` in every mode at every worker count."""
    arr = poisson_arrivals(8.0, 20, seed=5)
    out = {}
    for mode in MODES:
        for nw in WORKERS:
            be = SimBackend(index, emb, cost_model=RET_HEAVY, seed=0)
            s = Server(index, emb, mode=mode, backend=be, nprobe=12, topk=5,
                       num_ret_workers=nw)
            for i, t in enumerate(arr):
                s.add_request(f"q{i}", workflows.build(NAMES[i % 5]),
                              arrival_us=float(t))
            m = s.run()
            assert m.finished == 20, (mode, nw, m.finished)
            out[f"{mode}-nw{nw}"] = trace_hash(s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the paper workflows' trace hashes")
    ap.add_argument("--out", required=True, metavar="PATH", help="JSON output path")
    ap.add_argument("--device", default="cuda", help="where k-means runs: cuda or cpu")
    args = ap.parse_args(argv)
    path = Path(args.out).resolve()
    if path == GOLDENS:
        print(f"refusing to overwrite {GOLDENS.name}: it holds the reference package's hashes",
              file=sys.stderr)
        return 2
    out = fingerprints(*fixture(args.device))
    for key, val in out.items():
        print(f"{key}: {val}")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

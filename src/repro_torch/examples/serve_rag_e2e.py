"""End-to-end REAL-execution example: a tiny PyTorch LM served with continuous
batching + real IVF retrieval through the HedraRAG scheduler (wall-clock).

Everything actually executes: prompts are tokenised (toy byte tokenizer),
the GenerationEngine decodes real tokens from a randomly-initialised reduced
qwen3 model, retrieval runs against the IVF index with the hot-cluster cache
(the ``ivf_scan`` kernel on the card, its plain version on the CPU), and the
wavefront scheduler coordinates both.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_rag_e2e
      PYTHONPATH=src python -m repro_torch.examples.serve_rag_e2e --crossreq
      # + the cross-request layer: global semantic cache, in-flight query
      # dedup (duplicate prompts fuse into one retrieval), replica routing
      # knobs; --device cpu runs on the CPU
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
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
from repro_torch import workflows


def tokenize(text: str, vocab: int) -> np.ndarray:
    return (np.frombuffer(text.encode(), dtype=np.uint8).astype(np.int32)
            % (vocab - 2)) + 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--crossreq", action="store_true",
                    help="enable the cross-request layer (global semantic "
                         "cache + in-flight query dedup/fusion + replica "
                         "routing knobs)")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes for the example smoke test")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n_docs, n_clusters, max_len = (2_000, 12, 96) if args.smoke else (8_000, 32, 192)
    docs, _, topics = make_corpus(CorpusConfig(n_docs=n_docs, dim=48,
                                               n_topics=64))
    index = IVFIndex.build(docs, n_clusters=n_clusters, iters=4, device=device)
    embedder = SyntheticEmbedder(topics)
    hybrid = HybridRetrievalEngine(index, cache_capacity=8, update_interval=10,
                                   device=device)

    cfg = get_config("qwen3-1.7b").reduced()
    params = lm.init_params(cfg, seed=0, device=device)
    engine = GenerationEngine(cfg, params, max_batch=8, max_len=max_len,
                              eos_id=0, device=device)

    backend = RealBackend(engine, index, embedder, hybrid=hybrid)

    # bind engine sequences to scheduler generation stages: the scheduler's
    # sub-stage calls engine.step_batch; sequences are admitted on stage start
    orig_gen_duration = backend.gen_duration

    def gen_duration(n_prefill_tokens, batch, n_steps):
        while engine.can_admit() and _pending_prompts:
            prompt = _pending_prompts.pop(0)
            engine.add_sequence(tokenize(prompt, cfg.vocab_size), max_new=24)
        return orig_gen_duration(n_prefill_tokens, batch, n_steps)

    backend.gen_duration = gen_duration
    _pending_prompts: list[str] = []

    crossreq_kw = {}
    if args.crossreq:
        # replication needs a worker pool (> 1) to have replica holders
        crossreq_kw = dict(global_cache_size=64, dedup_threshold=0.95,
                           replication_factor=2, num_ret_workers=2)
    server = Server(index, embedder, mode="hedra", backend=backend, nprobe=8,
                    **crossreq_kw)
    n = args.n_requests
    queries = [f"what is retrieval augmented generation {i}?" for i in range(n)]
    for i, q in enumerate(queries):
        _pending_prompts.append(q)
        server.add_request(q, workflows.build("one-shot" if i % 2 else "hyde"),
                           arrival_us=i * 30_000.0)

    t0 = time.perf_counter()
    metrics = server.run()
    wall = time.perf_counter() - t0
    print("== real-execution RAG serving ==")
    print(f"wall time: {wall:.2f}s; engine generated real tokens via PyTorch "
          f"decode on {device}")
    for k, v in metrics.summary().items():
        print(f"  {k:24s} {v}")
    print("hot-cache stats:", hybrid.stats())
    if args.crossreq:
        print("crossreq report:", server.crossreq_report())
    assert metrics.finished == n, f"finished {metrics.finished}/{n}"


if __name__ == "__main__":
    main()

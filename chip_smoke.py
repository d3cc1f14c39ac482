#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device and build: refuses to run without a CUDA card, prints the card and
   its power limit, builds every CUDA kernel of the port with ``nvcc`` for
   ``sm_90a`` (in parallel, into ``build/kernels/``).
2. Set-up: a 1,000,000 x 1024 synthetic corpus (1024 is the width of
   e5-large, the paper's embedder) and its 4096-cluster IVF index, built on
   the card.
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes, each beside the tolerance it is held to.
4. The main path: ``Server(mode="hedra", nprobe=32)`` over ``RealBackend``,
   with qwen3-1.7b at full width and depth (28 layers, bf16, seeded random
   weights) and the hybrid retrieval engine (512 device-resident clusters),
   serves 8 requests of the paper's five workflows.  Every kernel's launch
   count is set to 0 just before and read just after; each must be > 0.
   The kernels are then held against their plain versions once more, on
   inputs the main path itself gave them.
5. Outputs checked by the repo's own means: device-path retrieval against
   the host path on the real index, and decode (the kernel) against
   prefill (plain attention) on a full-width model cut to 2 layers, in f32.
6. Times with CUDA events: each kernel, its plain version and (decode only)
   one PyTorch call computing the same function, at the main path's inputs,
   beside the least time the card could take for that work.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase exits nonzero without it.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# Main-path sizes.
N_DOCS, DIM, N_TOPICS, N_CLUSTERS, KMEANS_ITERS = 1_000_000, 1024, 4096, 4096, 4
ARCH, MAX_BATCH, MAX_LEN, MAX_NEW = "qwen3-1.7b", 8, 2048, 32
CACHE_CAPACITY, NPROBE, N_REQUESTS = 512, 32, 8
# Hot-cache refresh every sub-stage, with no modelled transit: the engine's
# defaults (50 and 2) are sized for long traffic, while 8 requests run only
# a few retrieval sub-stages.  Arrivals are spaced so that requests do not
# all run their rounds in lock step (one sub-stage per round for all).
CACHE_UPDATE_INTERVAL, CACHE_TRANSIT, ARRIVAL_GAP_US = 1, 0, 200_000.0
WORKFLOW_NAMES = ("one-shot", "hyde", "recomp", "multistep", "irg")

# Tolerances of the kernel-vs-plain comparisons.
# f32: the kernel and the plain version differ only in summation order.
F32 = dict(rtol=1e-4, atol=1e-5)
# ivf_scan on a bf16 slab: both sides widen the same bf16 values to f32, so
# again only summation order differs, but distances near 0 lose relative
# precision to the cancellation in ||q||^2 - 2q.t + ||t||^2: atol 1e-4.
IVF_BF16 = dict(rtol=1e-4, atol=1e-4)
# decode_attention in bf16: both sides compute in f32 and round the result
# to bf16 once; two f32 values a few ulps apart may round one bf16 step
# (2^-8 relative) apart.
ATTN_BF16 = dict(rtol=1e-2, atol=1e-2)
# decode (kernel) against prefill (plain) through 2 full-width f32 layers
# and the 151936-wide head: summation order over d_model 2048 and d_ff 6144.
MODEL_F32 = dict(rtol=1e-3, atol=1e-3)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12     # float32 outside the tensor cores
BF16_FLOPS = 989e12   # bf16 tensor cores


class SmokeFailure(RuntimeError):
    pass


def need(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, dev, fn, iters=20, warmup=3):
    """Mean ms of one ``fn()`` on the card (CUDA events around each call).

    Before each call a 256 MiB buffer is overwritten, so the call finds the
    50 MB L2 cache cold, as on the main path, where a decode step streams
    every layer's cache and a sub-stage's clusters were last touched long
    before.  The flush lies outside the timed region."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# kernel comparisons
# ---------------------------------------------------------------------------


def check_ivf(torch, ops, ref, q, gc, slab, valid, k, tol, what):
    """Kernel against plain on one input; returns (max_abs_err, boundary ties).

    Only real query rows are compared: the all-zero rows that pad a group to
    QB see every row of the cluster at one distance, all ties."""
    dk, ik = ops.ivf_scan(q, gc, slab, valid, k)
    torch.cuda.synchronize()
    kk = min(k + 1, slab.shape[1])
    dr, ir = ref.ivf_scan_ref(q, gc, slab, valid, kk)
    nxt = dr[..., k] if kk > k else torch.full(dr.shape[:-1], float("inf"), device=dr.device)
    real = q.abs().sum(-1) > 0
    err, ties, bad = ref.topk_agreement(dr[..., :k][real].cpu(), ir[..., :k][real].cpu(),
                                        nxt[real].cpu(), dk[real].cpu(), ik[real].cpu(), **tol)
    log(f"  ivf_scan {what}: max_abs_err={err:.3e} (rtol={tol['rtol']}, atol={tol['atol']}) "
        f"boundary_ties={ties} mismatched_rows={bad}")
    need(bad == 0, f"ivf_scan {what}: {bad} query rows disagree with the plain version")
    return err, ties


def check_attn(torch, ops, ref, q, k, v, lengths, tol, what):
    out = ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    exp = ref.decode_attention_ref(q, k, v, lengths)
    err = float((out.float() - exp.float()).abs().max())
    ok = bool(torch.allclose(out.float(), exp.float(), **tol))
    log(f"  decode_attention {what}: max_abs_err={err:.3e} "
        f"(rtol={tol['rtol']}, atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
    need(ok and torch.isfinite(out).all(), f"decode_attention {what} disagrees with the plain version")
    return err


def ivf_cases(torch, ivf_ops, ivf_ref, index, tile_len, dev):
    """ivf_scan at main-path shapes on real index clusters, plus edge cases."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    C, G, QB = 64, 48, 8
    cids = rng.choice(index.n_clusters, C, replace=False)
    slab = np.zeros((C, tile_len, index.dim), np.float32)
    valid = np.zeros((C,), np.int32)
    for s, cid in enumerate(cids):
        lo, hi = int(index.offsets[cid]), int(index.offsets[cid + 1])
        slab[s, : hi - lo] = index.flat[lo:hi]
        valid[s] = hi - lo
    gc = rng.integers(0, C, size=G).astype(np.int32)
    # queries near the probed cluster's centroid, as IVF probes are
    q = index.centroids[cids[gc]][:, None, :] + 0.05 * rng.standard_normal((G, QB, index.dim))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    t = {name: torch.from_numpy(a).to(dev) for name, a in
         (("q", q), ("gc", gc), ("slab", slab), ("valid", valid))}
    errs, ties = [], 0
    for k in (5, 24):
        for sdt, tol in ((torch.float32, F32), (torch.bfloat16, IVF_BF16)):
            e, n = check_ivf(torch, ivf_ops, ivf_ref, t["q"], t["gc"], t["slab"].to(sdt),
                             t["valid"], k, tol, f"k={k} slab={str(sdt)[6:]} L={tile_len}")
            errs.append(e)
            ties += n
    # duplicate distances: identical rows, lower row wins; an empty cluster
    dup = torch.ones((2, tile_len, index.dim), device=dev)
    dvalid = torch.tensor([tile_len, 0], dtype=torch.int32, device=dev)
    dq = torch.zeros((2, QB, index.dim), device=dev)
    dgc = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    dd, di = ivf_ops.ivf_scan(dq, dgc, dup, dvalid, 24)
    torch.cuda.synchronize()
    need(torch.equal(di[0].cpu(), torch.arange(24, dtype=torch.int32).expand(QB, 24)),
         "ivf_scan duplicates: ties must go to the lower row")
    need(bool(torch.isinf(dd[1]).all()) and bool((di[1] == -1).all()),
         "ivf_scan empty cluster: every slot must be (+inf, -1)")
    log("  ivf_scan duplicate rows: ids 0..23 in order; valid=0 cluster: all (+inf, -1)")
    return max(errs), ties


def attn_cases(torch, attn_ops, attn_ref, dev):
    """decode_attention at qwen3-1.7b shapes (bf16) and the JAX test shapes (f32)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)

    def make(B, H, KV, dh, S, dtype):
        q = torch.as_tensor(rng.standard_normal((B, H, dh)), dtype=torch.float32, device=dev)
        k = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), dtype=torch.float32, device=dev) * 0.3
        v = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), dtype=torch.float32, device=dev)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    errs = []
    q, k, v = make(8, 16, 8, 128, 2048, torch.bfloat16)
    lengths = torch.tensor([1, 2, 31, 33, 517, 1024, 2047, 2048], dtype=torch.int32, device=dev)
    errs.append(check_attn(torch, attn_ops, attn_ref, q, k, v, lengths, ATTN_BF16,
                           "qwen3-1.7b B=8 H=16 KV=8 dh=128 S=2048 bf16"))
    for B, H, KV, dh, S in ((2, 8, 4, 64, 512), (2, 16, 8, 128, 1024), (1, 10, 1, 256, 512),
                            (2, 32, 32, 96, 256), (3, 16, 8, 128, 1000)):
        q, k, v = make(B, H, KV, dh, S, torch.float32)
        lengths = torch.as_tensor(rng.integers(1, S + 1, size=B), dtype=torch.int32, device=dev)
        lengths[0] = 1
        errs.append(check_attn(torch, attn_ops, attn_ref, q, k, v, lengths, F32,
                               f"B={B} H={H} KV={KV} dh={dh} S={S} f32"))
    return max(errs)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


class Recorder:
    """Calls through to a kernel wrapper and keeps the inputs of the call
    that ``weight`` ranks highest, so kernels can be re-run on what the main
    path gave them.  The wrapper counts its own launches; this adds none."""

    def __init__(self, fn, weight):
        self.fn, self.weight = fn, weight
        self.best, self.best_w = None, -1

    def __call__(self, *args):
        w = self.weight(*args)
        if w > self.best_w:
            self.best_w = w
            self.best = args
        return self.fn(*args)


def serve_main_path(torch, dev, index, embedder):
    import numpy as np

    import repro_torch.models.layers as layers_mod
    import repro_torch.retrieval.hybrid as hybrid_mod
    from repro_torch import workflows
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ivf_scan import ivf_scan
    from repro_torch.launch.serve import build_server
    from repro_torch.models import lm
    from repro_torch.retrieval import HybridRetrievalEngine
    from repro_torch.serving.engine import GenerationEngine

    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    log(f"  {ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, init {time.perf_counter() - t0:.1f}s")
    engine = GenerationEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN, eos_id=-1,
                              device=dev)
    hybrid = HybridRetrievalEngine(index, cache_capacity=CACHE_CAPACITY,
                                   update_interval=CACHE_UPDATE_INTERVAL,
                                   transit_substages=CACHE_TRANSIT, device=dev)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int64)
               for n in rng.integers(512, 1025, size=N_REQUESTS)]
    server = build_server(engine, index, embedder, hybrid, prompts, max_new=MAX_NEW,
                          nprobe=NPROBE)
    # observe the inputs the main path hands each kernel (largest work kept)
    ivf_rec = Recorder(hybrid_mod.ivf_scan, lambda q, gc, slab, valid, k: q.shape[0])
    order = itertools.count()  # decode: keep the last call (longest cache)
    attn_rec = Recorder(layers_mod.decode_attention, lambda q, k, v, lengths: next(order))
    hybrid_mod.ivf_scan, layers_mod.decode_attention = ivf_rec, attn_rec
    names = [WORKFLOW_NAMES[i % len(WORKFLOW_NAMES)] for i in range(N_REQUESTS)]
    generated = []
    orig_step = engine.step

    def step():
        out = orig_step()
        generated.extend(out.values())
        return out

    engine.step = step
    try:
        torch.cuda.reset_peak_memory_stats()
        ivf_scan.launches = 0
        decode_attention.launches = 0
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            server.add_request(f"request {i}", workflows.build(name), arrival_us=i * ARRIVAL_GAP_US)
        m = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ivf_scan": ivf_scan.launches, "decode_attention": decode_attention.launches}
    finally:
        hybrid_mod.ivf_scan, layers_mod.decode_attention = ivf_rec.fn, attn_rec.fn
    st = hybrid.stats()
    log(f"  workflows: {', '.join(names)}")
    log(f"  finished={m.finished}/{N_REQUESTS} wall={wall:.2f}s tokens_generated={len(generated)} "
        f"substages_ret={m.summary().get('substages_ret')} "
        f"substages_with_device_probes={launches['ivf_scan']} cache_hits={st['hits']} "
        f"cache_misses={st['misses']} uploads={st['uploads']}")
    log(f"  launches: {launches}  max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    need(m.finished == N_REQUESTS, f"finished {m.finished} of {N_REQUESTS} requests")
    for name, n in launches.items():
        need(n > 0, f"the main path launched {name} no time")
    need(len(generated) > 0 and all(0 <= t < cfg.vocab_size for t in generated),
         "generated tokens must lie in the vocabulary")
    return launches, ivf_rec.best, attn_rec.best, hybrid, engine


def check_retrieval_against_host(torch, index, hybrid, embedder):
    """Device path (the kernel) against the host path on the real index."""
    import numpy as np

    from repro_torch.retrieval.plan import BatchTopK, PlanBuilder

    queries = np.stack([embedder.embed_query(i, 0) for i in range(16)]).astype(np.float32)
    probes = index.probe_order(queries, NPROBE)
    b = PlanBuilder()
    for i in range(len(queries)):
        b.add(queries[i], probes[i], k=10)
    plan = b.build()
    resident = hybrid.resident_mask()
    n_dev = int(resident[plan.seg_cluster].sum())
    dev_out = hybrid.search_plan(plan, resident=resident)
    host_out = BatchTopK.empty(plan.n_items, plan.k)
    index.scan_segments(plan, np.arange(plan.n_segments), host_out)
    same = dev_out.ids == host_out.ids
    fin = np.isfinite(host_out.dists)
    err = float(np.abs(dev_out.dists[fin] - host_out.dists[fin]).max())
    log(f"  retrieval: {plan.n_segments} clusters probed, {n_dev} on the device path; "
        f"ids equal in {int(same.all(-1).sum())}/{plan.n_items} items; max |dist diff|={err:.3e}")
    need(n_dev > 0, "no probed cluster was resident for the retrieval check")
    need(np.allclose(dev_out.dists[fin], host_out.dists[fin], rtol=1e-4, atol=1e-5),
         "device-path distances disagree with the host path")
    # an id may differ only where two rows tie within the tolerance
    for r, c in zip(*np.nonzero(~same)):
        need(np.isclose(dev_out.dists[r, c], host_out.dists[r, c], rtol=1e-4, atol=1e-5),
             "device-path ids disagree with the host path")


def check_decode_against_prefill(torch, dev):
    """Full-width qwen3-1.7b cut to 2 layers, f32: the logits of one decode
    step (the decode kernel) equal prefill's over the same tokens (plain
    blocked attention)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    base = get_config(ARCH)
    cfg = dataclasses.replace(base, n_layers=2, dtype="float32",
                              segments=(dataclasses.replace(base.segments[0], repeat=2),))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    params = lm.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(SEED + 4)
    B, S = 4, 300
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(B, S + 1)), device=dev)
    want, _ = lm.prefill(params, cfg, toks, max_len=S + 1)
    _, state = lm.prefill(params, cfg, toks[:, :S], max_len=S + 1)
    got, _ = lm.decode_step(params, cfg, toks[:, S].to(torch.int32), state)
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **MODEL_F32)) and bool(torch.isfinite(got).all())
    log(f"  decode vs prefill logits ({B}x{cfg.vocab_size}, 2 layers f32): max_abs_err={err:.3e} "
        f"(rtol={MODEL_F32['rtol']}, atol={MODEL_F32['atol']}) {'ok' if ok else 'FAIL'}")
    need(ok, "decode logits disagree with prefill logits")


def time_kernels(torch, dev, ivf_in, attn_in, engine):
    """Phase 6: each kernel, its plain version and (decode) SDPA, timed on
    the inputs the main path gave them, beside the bound of that work."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    from repro_torch.kernels.ivf_scan import ref as ivf_ref
    from repro_torch.models import lm

    q, gc, slab, valid, k = ivf_in
    aq, ak, av, alen = attn_in
    G, QB, d = q.shape
    real_q = int((q.abs().sum(-1) > 0).sum())
    rows = valid[gc.long()].long()
    uniq = torch.unique(gc.long())
    ivf_bytes = (int(valid[uniq].long().sum()) * d * slab.element_size() + q.numel() * q.element_size()
                 + 4 * (G + slab.shape[0]) + G * QB * k * 8)
    ivf_ops_n = 2 * d * int((rows * (q.abs().sum(-1) > 0).sum(-1)).sum())
    ivf_bound, ivf_by = bound(ivf_bytes, ivf_ops_n, F32_FLOPS)
    ivf_ms = time_ms(torch, dev, lambda: ivf_ops.ivf_scan(q, gc, slab, valid, k))
    ivf_plain = time_ms(torch, dev, lambda: ivf_ref.ivf_scan_ref(q, gc, slab, valid, k), iters=5)
    log(f"  ivf_scan G={G} QB={QB} (real queries {real_q}) d={d} L={slab.shape[1]} k={k}: "
        f"{ivf_bytes} bytes, {ivf_ops_n} f32 FLOP; kernel {ivf_ms:.4f} ms, plain "
        f"{ivf_plain:.4f} ms, bound {ivf_bound:.4f} ms ({ivf_by}), library none")

    B, H, dh = aq.shape
    KV = ak.shape[2]
    lens = alen.long()
    esz = ak.element_size()
    attn_bytes = int(lens.sum()) * KV * dh * esz * 2 + 2 * aq.numel() * esz + 4 * B
    attn_ops_n = 4 * int(lens.sum()) * H * dh
    attn_bound, attn_by = bound(attn_bytes, attn_ops_n, BF16_FLOPS)
    attn_ms = time_ms(torch, dev, lambda: attn_ops.decode_attention(aq, ak, av, alen), iters=50)
    attn_plain = time_ms(torch, dev, lambda: attn_ref.decode_attention_ref(aq, ak, av, alen))
    mask = (torch.arange(ak.shape[1], device=dev)[None, :] < alen[:, None])[:, None, None, :]
    # SDPA's (B, heads, S, dh) layout: copies made once, outside the timing
    kt, vt = ak.transpose(1, 2).contiguous(), av.transpose(1, 2).contiguous()
    qt = aq[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err = float((sdpa()[:, :, 0].float() - attn_ref.decode_attention_ref(aq, ak, av, alen).float())
                    .abs().max())
    attn_lib = time_ms(torch, dev, sdpa, iters=50)
    log(f"  decode_attention B={B} H={H} KV={KV} dh={dh} S={ak.shape[1]} "
        f"sum(lengths)={int(lens.sum())}: {attn_bytes} bytes, {attn_ops_n} FLOP; kernel "
        f"{attn_ms:.4f} ms, plain {attn_plain:.4f} ms, SDPA {attn_lib:.4f} ms "
        f"(max |SDPA - plain| {lib_err:.3e}), bound {attn_bound:.4f} ms ({attn_by})")
    # the decode step those launches sit in: all layers at the same state
    step_ms = time_ms(torch, dev, lambda: lm.decode_step(engine.params, engine.cfg,
                                                    engine._last_tokens, engine.state), iters=5)
    n_layers = engine.cfg.n_layers
    log(f"  decode step B={B} ({n_layers} layers, eager PyTorch + {n_layers} decode_attention "
        f"launches): {step_ms:.3f} ms; attention kernels {n_layers * attn_ms:.3f} ms of it "
        f"({100 * n_layers * attn_ms / step_ms:.1f}%)")

    return {
        "ivf_scan": {"ms": ivf_ms, "plain_ms": ivf_plain, "bound_ms": ivf_bound,
                     "bound_by": ivf_by, "library_ms": None},
        "decode_attention": {"ms": attn_ms, "plain_ms": attn_plain, "bound_ms": attn_bound,
                             "bound_by": attn_by, "library_ms": attn_lib},
    }


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from the repository: src/repro_torch is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    t_all = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    from repro_torch.kernels.ivf_scan import ref as ivf_ref
    from repro_torch.retrieval import CorpusConfig, IVFIndex, SyntheticEmbedder, make_corpus

    # 1. device and build ----------------------------------------------------
    log("[1] device and build")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; device: {kind}")
    log(smi_line)
    t0 = time.perf_counter()
    took = _build.build()
    log(f"  built {', '.join(f'{n} {s:.1f}s' for n, s in took.items())} "
        f"(wall {time.perf_counter() - t0:.1f}s) into {_build.BUILD_DIR.relative_to(ROOT)}")

    # 2. set-up: corpus and index -----------------------------------------------
    log("[2] corpus and IVF index")
    t0 = time.perf_counter()
    docs, _, topics = make_corpus(CorpusConfig(n_docs=N_DOCS, dim=DIM, n_topics=N_TOPICS,
                                               seed=SEED))
    log(f"  corpus {docs.shape} {docs.dtype} in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    index = IVFIndex.build(docs, N_CLUSTERS, iters=KMEANS_ITERS, seed=SEED, device=dev)
    del docs
    sizes = index.cluster_sizes()
    tile_len = max(128, int(-(-sizes.max() // 128) * 128))
    log(f"  index: {N_CLUSTERS} clusters (sizes min {sizes.min()} mean {sizes.mean():.1f} "
        f"max {sizes.max()}), tile_len {tile_len}, built in {time.perf_counter() - t0:.1f}s")
    embedder = SyntheticEmbedder(topics)

    # 3. kernels against their plain versions -----------------------------------
    log("[3] kernels against their plain versions")
    ivf_err, ivf_ties = ivf_cases(torch, ivf_ops, ivf_ref, index, tile_len, dev)
    attn_err = attn_cases(torch, attn_ops, attn_ref, dev)
    log(f"  ivf_scan boundary ties counted: {ivf_ties}")

    # 4. the main path ----------------------------------------------------------
    log("[4] main path: Server + RealBackend, 8 requests")
    launches, ivf_in, attn_in, hybrid, engine = serve_main_path(torch, dev, index, embedder)
    q, gc, slab, valid, k = ivf_in
    e, n = check_ivf(torch, ivf_ops, ivf_ref, q, gc, slab, valid, k, F32,
                     f"main-path input G={q.shape[0]} k={k}")
    ivf_err, ivf_ties = max(ivf_err, e), ivf_ties + n
    aq, ak, av, alen = attn_in
    attn_err = max(attn_err, check_attn(torch, attn_ops, attn_ref, aq, ak, av, alen, ATTN_BF16,
                                        f"main-path input B={aq.shape[0]} lengths={alen.tolist()}"))

    # 5. outputs by the repo's own means ----------------------------------------
    log("[5] outputs")
    check_retrieval_against_host(torch, index, hybrid, embedder)
    check_decode_against_prefill(torch, dev)

    # 6. times ------------------------------------------------------------------
    log("[6] times at the main path's inputs (CUDA events, cold L2)")
    t = time_kernels(torch, dev, ivf_in, attn_in, engine)

    kernels = [
        {"name": "ivf_scan", "route": "cuda", "source": "src/repro_torch/csrc/ivf_scan.cu",
         "replaces": "src/repro/kernels/ivf_scan/ivf_scan.py:111",
         "launches": launches["ivf_scan"], "max_abs_err": ivf_err, **t["ivf_scan"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/decode_attention.py:80",
         "launches": launches["decode_attention"], "max_abs_err": attn_err,
         **t["decode_attention"]},
    ]
    log(f"  total {time.perf_counter() - t_all:.1f}s")
    need(all(np.isfinite([r["ms"], r["plain_ms"], r["bound_ms"]]).all() for r in kernels),
         "a time is not finite")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)

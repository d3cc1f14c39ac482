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
   path's shapes and at edge cases, each beside the tolerance it is held to
   (``topk_merge`` does no arithmetic and is held bit for bit).  The split
   kernels also at forced small splits (cache lengths and valid counts at
   and around split edges, identical rows across an edge, length 0), and
   each twice on one input, which must give the same bits.  ``topk_merge``
   also at forced chunks of its sorting network, k past its register path
   up to its limit, and rows of 20,000 candidates.  ``decode_attention``
   also in bf16 at every other family's full-width decode shape (dh 96,
   160, 64, 128 and 256, recurrentgemma's over its 2048-row ring).  The
   model body's fused kernels (``norm``, ``qk_rope``, ``glu``) at the main
   path's decode and prefill shapes and at edge cases (the zoo's widths,
   d_head 64 / 96 / 128 / 160 / 256, odd row counts, f32, a strided row, a
   ring slot, position 0 and a position past the cache's end): the norms
   within 1 ulp (bf16), the residual sums, RoPE, the cache writes and the
   activations bit for bit, the share of differing elements printed.
4. The main path: ``Server(mode="hedra", nprobe=32)`` over ``RealBackend``,
   with qwen3-1.7b at full width and depth (28 layers, bf16, seeded random
   weights) and the hybrid retrieval engine (512 device-resident clusters),
   serves 8 requests of the paper's five workflows.  The engine's decode
   step is one CUDA graph, captured when the engine is built and replayed
   at each step; each replay adds the launches it recorded to each
   kernel's count (28 ``decode_attention``, 57 ``norm``, 28 ``qk_rope``,
   28 ``glu``; a prefill graph's norm, qk_rope and glu likewise).  Each admission (prefill + slot insert) is a CUDA
   graph of its padded width, captured at the width's first admission and
   replayed at the later ones: at most 2 of the 8 prefills run eagerly,
   and the host clock splits the prefills that captured from those that
   replayed; the prefill graphs' pool is printed.  Every kernel's launch count is set to 0 just
   before and read just after; each must be > 0.  The kernels are then
   held against their plain versions once more, on inputs the main path
   itself gave them (the decode recorder goes in before the engine is
   built, so it sees the capture).
5. Outputs checked by the repo's own means: device-path retrieval against
   the host path on the real index, and decode (the kernel) against
   prefill (plain attention) on a full-width model cut to 2 layers, in f32.
7. The sharded search: the whole index packed into a (4096, L, 1024) f32
   slab on the card (~12.9 GB), split over a gloo group of 4 spawned ranks
   on the one card (each rank's tile range reaches it by CUDA IPC);
   ``make_sharded_search`` scans each range and merges the all-gathered
   lists with ``topk_merge``.  Held against ``reference_search`` over the
   whole slab and against an exact f64 brute force over the index's rows;
   every rank must have launched the kernel.
8. Shard-mode serving: ``build_server(ret_workers=4, index_sharding=True)``
   over phase 4's engine and a fresh 512-slot hybrid engine in shard mode
   serves 8 requests while a ``FaultPlan`` crashes one of the 4 workers;
   every request terminates, each surviving owner's device path (its own
   slots) agrees with the host path, and ``scatter_gather_search`` over
   the surviving shards equals its one-plan oracle.
9. The wall-clock serving stack: 12 requests drawn from the ten-class
   heterogeneous mix (compress and pipeline among them) and 4 repeats of
   earlier ones go through ``Server.serve_wallclock`` (producer and
   heartbeat threads, ``DurationTape`` recording) over phase 4's params, a
   fresh engine and a fresh 512-slot hybrid engine with replication 2,
   with the cross-request layer (global cache, in-flight fusion, replicas
   over 2 workers), tracing and telemetry on.  Every request terminates;
   both kernels launch; queries fuse and replicas load; a fused plan's
   device scan is held against the plain version; each worker's device view
   agrees with the host path; the trace, the attribution (residual check)
   and the Prometheus text are read; a fresh stack replays the arrival trace
   and the tape to the same fingerprints bit for bit.  Then the launcher
   runs on the card (``--wallclock --closed-loop 4 --replay-check``) and
   must exit 0.
6. Times with CUDA events (run after phase 9, on the inputs phases 4 and 7
   gave the kernels): each kernel, its plain version and, where there is
   one, one PyTorch call computing the same function, beside the least time the
   card could take for that work and the time of one ``torch.sum`` over as
   many bytes; qwen3's decode step at phase 4's state, eager (the step
   body op by op) and replayed (the captured graph), beside the bytes it
   must move over the card's memory rate, and one of each under
   ``torch.profiler`` (device ops, device-busy and wall time, the
   costliest kernels); qwen3's admission at padded widths 512 and 1024
   into phase 4's slab, eager and replayed, beside each width's floor (its
   bf16 GEMMs and f32 attention at their peaks, or its bytes), one of each
   under the profiler, and the prefill graphs' pool; the replays' device
   time grouped by kernel name (top 15 a step, 20 an admission, with
   counts); the same step and
   admissions through a twin engine captured under the plain-on-card switch
   (the plain chains: the model body before the fused kernels); in the
   replayed step and admissions, the norm's launches and the bf16
   elementwise adds (qwen3's step must run none: every residual add is a
   norm's delta); the fused kernels at the decode and prefill shapes beside
   their byte bounds, their plain versions, ``F.rms_norm`` for the norm and
   one ``torch.sum``, and ``norm``, ``F.rms_norm`` and ``qk_rope`` three
   ways more: (a) CUDA events around one call after the L2 flush, (b) the
   profiler's device time of one call after the flush (and back to back
   without it), (c) one of 57 calls in a captured graph; then
   qwen3-1.7b at full width and depth, 8 prompts x 32 tokens through the
   captured engine with the fused kernels and under the switch: the greedy
   streams must be equal, or differ first where the plain run's top-2 logit
   margin is below the teacher-forced logit difference (a near-tie);
   ``ivf_scan`` also at a fixed shape made from SEED
   (17 real clusters, one real query a group, k 5), which the main path's varying
   G does not give; ``topk_merge`` also at pod scale (Q 8192, k 32, m 96)
   on random lists and on sorted ones as ``make_sharded_search`` gives
   them, each also at the other chunk sizes of its sorting network.
10. deepseek-v2-lite-16b (MLA, 64 experts top-6 + 2 shared) at full width
   and depth (27 layers, 15.71 B params, bf16, seeded random weights) served
   as phase 4 serves qwen3, over phase 4's index and a fresh hybrid engine
   (phases 4-9's stacks freed first); ``ivf_scan`` must launch (MLA decodes
   in latent space, without ``decode_attention``).  Its decode step and
   its admission at width 1024 timed eager and replayed as in phase 6,
   peak memory printed; decode against
   prefill on 2 full-width f32 layers (the dense one and one MoE layer,
   capacity past any drop).
11. The rest of the zoo at full width, one model at a time, each cut to its
   first segment period in f32: decode against prefill for phi3, stablelm,
   qwen1.5 (qkv bias), llama4-scout (MoE), recurrentgemma (RG-LRU, RG-LRU,
   local attention; prompts of 1000 and 2100 tokens, either side of its
   2048-row ring), rwkv6, paligemma (256 prefix embeddings) and whisper
   (2 encoder layers over 1500 frames, cross-attention).  Every
   decoder-only family (qwen3 and deepseek too), cut to 2-3 layers in f32,
   is served by a captured engine (its decode graph and a prefill graph at
   each of the widths 64, 128 and 504, one replayed after later captures),
   by one running both bodies op by op and by one captured under the
   plain-on-card switch (graphs of the plain chains, not the fused
   kernels): 5 prompts through 2 slots, retired and refilled mid-stream,
   to the same greedy tokens.  Then qwen3-1.7b at
   full depth in bf16 with the int8 KV cache against the bf16 cache: cosine
   > 0.999 at each of 8 decode steps, and the card's int8 codes and
   scales equal the CPU's bit for bit.
12. Training: (a) qwen3-1.7b at full width and depth (28 layers, bf16,
   remat) takes 4 AdamW steps through ``make_train_step`` on one repeated B
   2 x S 4096 ``SyntheticTokenStream`` batch, at lr 1e-3 (printed: it
   swings up) and at lr 3e-5: every loss finite, the last below the first
   at 3e-5; step time, tokens/s, model TFLOP/s and peak memory printed. (b)
   One step of the full-width model cut to 2 layers in f32 on the card and
   on the CPU from the same converted parameters. (c) Every other family at
   full width cut to its first segment period: the train loss equals the
   cross-entropy of the port's own forward logits, and every gradient is
   finite. (d) Checkpoint and resume at 2 layers through ``ElasticRunner``:
   the resumed step equals the uninterrupted run bit for bit. (e)
   ``ErrorFeedback`` and the int8 codes over (a)'s gradients on the card
   (codes equal to the CPU's), ``compressed_psum_leaf`` over 2 gloo ranks
   on the card, and the train launcher as a subprocess, run and then
   resumed from its step-3 checkpoint. No CUDA kernel of the port is on the
   training path (its attention is the plain blocked attention, as the JAX
   package's is jnp, and train mode runs the plain chains: the fused
   kernels have no backward): each kernel's launches over phase 12 are
   read and must be 0.
13. The mesh: (a) ``launch.dryrun`` traces one step of qwen3-1.7b train_4k
   and decode_32k and deepseek-v2-lite-16b train_4k on the production mesh
   (data=32, model=8; a fake group of 256 ranks and fake tensors, each cell
   a process of its own, all at once): per-device argument bytes (equal to
   the shard sizes reckoned by hand from the specs) and peak, FLOPs,
   collectives by op and mesh dim, and the roofline terms (H100 data-sheet
   figures); the model FLOPs must be 6·N·D (train) or 2·N·D (decode).  (b)
   A mesh of ``MESH_SHAPE`` ranks spawned on the card (one NCCL rank: see
   the note at ``MESH_BACKEND``; the (2, 2) mesh of 4 gloo processes runs in
   the CPU tests), with qwen3-1.7b at full width cut to 2 layers in f32: one
   train step at B 4 x S 256 through the DTensor path against the
   unsharded step, and a prefill of B 4 x 256 into a 512-row cache laid
   out by the decode-state rules, then 8 greedy decode steps, whose tokens
   must equal the unsharded run's; every rank must launch
   ``decode_attention`` on its block, and the kernel's log-sum-exp output
   on that block is held against the plain version.  (c) ``launch.train`` on
   the card through its host mesh ((1, 1)) for 3 steps: its losses must
   equal the one-device loop's (no mesh).  Phase 3 also holds the
   log-sum-exp output against the plain version (one chunk, split, forced
   chunks, -inf at length 0), and phase 6 times the kernel with it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase exits nonzero without it.

    python3 chip_smoke.py --mesh 2,2

runs phase 13b alone on a (2, 2) NCCL mesh of 4 cards, one rank a card
(the sequence-sharded decode combining its ranks' blocks for real).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import queue
import socket
import subprocess
import sys
import time
import traceback
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
# Sharded-path sizes: a world of 4 ranks on the one card (phase 7); 4
# shard-owning retrieval workers, worker 1 crashing at 0.3 s of virtual
# time, which the 8 requests (arrivals up to 1.4 s) outlast (phase 8).
WORLD, SHARD_K, SHARD_QUERIES, RANK_TIMEOUT_S = 4, 10, 16, 300
SHARD_WORKERS, CRASH_WORKER, CRASH_AT_US = 4, 1, 300_000.0
# topk_merge at pod scale (phase 6): 8192 queries, k 32, 3 candidate lists.
POD_Q, POD_K, POD_M = 8192, 32, 96
# The wall-clock stack (phase 9): 12 requests drawn from the heterogeneous
# mix (seed 5 draws multi-round, compress and pipeline requests) and 4 that
# repeat an earlier one (its text and workflow) at its arrival instant,
# served at speedup 1 (charges are measured, so virtual time runs at the
# wall clock's rate) with the example's cross-request knobs over 2 workers.
WC_DRAWN, WC_REPEATS, WC_RATE, WC_SEED, WC_MAX_WALL_S = 12, 4, 20.0, 5, 90.0
WC_SERVER = dict(ret_workers=2, global_cache_size=64, dedup_threshold=0.95,
                 replication_factor=2, tracing=True, telemetry=True,
                 external_heartbeats=True, fault_tolerance=True)
# The rest of the zoo: phase 10 serves the MLA + MoE model at full width and
# depth as phase 4 serves qwen3; phase 11 checks each other family at full
# width cut to its first segment period (arch, layers, prompt lengths: for
# recurrentgemma below and above its 2048-row window, neither a multiple).
MOE_ARCH = "deepseek-v2-lite-16b"
ZOO = (("phi3-mini-3.8b", 2, (300,)), ("stablelm-12b", 2, (300,)), ("qwen1.5-110b", 2, (300,)),
       ("llama4-scout-17b-a16e", 2, (300,)), ("recurrentgemma-2b", 3, (1000, 2100)),
       ("rwkv6-1.6b", 2, (300,)), ("paligemma-3b", 2, (300,)), ("whisper-medium", 2, (300,)))
# qwen3's int8 KV cache against its bf16 cache: batch, prompt, decode steps
INT8_RUN = (4, 512, 8)
# each family's captured engine against its eager bodies (phase 11): prompt
# lengths, new tokens for each (unequal: slots retire mid-stream), the
# cache's length, and the padded widths these give: 64, 504 (300 tokens
# with 8 new: the bucket 512 clipped to the 504 rows the decode room
# leaves), 128, 128, then 64 again, replayed after later captures
ENGINE_PROMPTS, ENGINE_MAX_NEW, ENGINE_MAX_LEN = (40, 300, 120, 75, 50), (3, 8, 5, 6, 4), 512
ENGINE_WIDTHS = (64, 128, 504)
# the admission's padded widths timed in phase 6 (qwen3) and, the last,
# in phase 10 (deepseek)
PREFILL_WIDTHS = (512, 1024)
# decode_attention at each family's full-width decode shape (phase 3, bf16):
# (arch, H, KV, dh, cache rows); recurrentgemma's cache is its ring
ATTN_SHAPES = (("phi3-mini-3.8b", 32, 32, 96, 2048), ("stablelm-12b", 32, 8, 160, 2048),
               ("recurrentgemma-2b", 10, 1, 256, 2048), ("paligemma-3b", 8, 1, 256, 2048),
               ("whisper-medium", 16, 16, 64, 2048), ("llama4-scout-17b-a16e", 40, 8, 128, 2048),
               ("qwen1.5-110b", 64, 8, 128, 2048))
# ... and the launcher itself, at its default reduced config
LAUNCHER_ARGS = ("--wallclock", "--closed-loop", "4", "--n-requests", "8", "--replay-check")
LAUNCHER_TIMEOUT_S = 300

# Training (phase 12): qwen3-1.7b at train_4k's sequence length with its
# global batch of 256 cut to 2 (one card, the script's time), 4 steps on one
# repeated batch; the card-vs-CPU step at 2 layers, B 1 x S 256, f32; each
# other family's train loss at (B, S); checkpoint/resume at 2 layers, 2 steps
# then 1; the 2-rank compressed sum; the launcher's run and its resume.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 4
# AdamW without warmup on bf16 parameters (no f32 master copy, as in the JAX
# package): at lr 1e-3 the full-depth model's loss swings up (11.86 -> 22.46
# in 4 steps); at 3e-5 it falls at each step.  12a runs 1e-3 for the record
# (finite losses) and trains at 3e-5
TRAIN_OPT = dict(lr=3e-5, warmup_steps=1)
DIVERGING_LR = 1e-3
CPU_STEP_B, CPU_STEP_S = 1, 256
ZOO_TRAIN_B, ZOO_TRAIN_S = 2, 300
# llama4-scout and qwen1.5-110b train in bf16 even at 2 layers: f32
# parameters and gradients would take ~52 and ~42 GB
ZOO_TRAIN_BF16 = ("llama4-scout-17b-a16e", "qwen1.5-110b")
PSUM_WORLD = 2
TRAIN_LAUNCHER_ARGS = ("--arch", "qwen3-1.7b", "--reduced", "--steps", "6", "--save-every", "3")

# The mesh (phase 13): the dry-run's cells on the production mesh of 256
# ranks (a fake group, no data moves); a mesh on the one card running
# qwen3-1.7b at full width cut to 2 layers, f32: one train step at B 4 x S
# 256 (lr 1e-3, no warmup), a prefill of B 4 x 256 into a 512-row cache and
# 8 greedy decode steps; the train launcher at its reduced config for 3
# steps through the host mesh.  The card's mesh is one NCCL rank, (1, 1):
# a (2, 2) mesh of 4 gloo ranks on the one card (NCCL refuses two ranks on
# one device) dies in its first all-gather, since gloo's functional
# all_gather_into_tensor on CUDA tensors ends in a segmentation fault
# (torch 2.11; the other collectives DTensor uses run:
# ``python -m repro_torch.scripts.probe_collectives``), and collectives are
# not staged through the host.  The (2, 2) mesh runs in the CPU tests.
MESH_BACKEND, MESH_SHAPE = "nccl", (1, 1)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "decode_32k"),
                ("deepseek-v2-lite-16b", "train_4k"))
DRYRUN_TIMEOUT_S = 400
MESH_LAYERS, MESH_TRAIN_B, MESH_TRAIN_S = 2, 4, 256
MESH_DECODE_B, MESH_PROMPT, MESH_MAX_LEN, MESH_STEPS = 4, 256, 512, 8
MESH_OPT = dict(lr=1e-3, warmup_steps=1)
MESH_LAUNCHER_ARGS = ("--arch", "qwen3-1.7b", "--reduced", "--steps", "3", "--save-every", "100")

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
# decode_attention's log-sum-exp output: both sides compute it in f32 from
# the same inputs (the kernel in base 2 over its chunks, the plain version
# with torch.logsumexp), so only rounding in the sums differs.
ATTN_LSE = dict(rtol=1e-5, atol=1e-4)
# the (2, 2) mesh's train step against the unsharded step on the card (f32,
# TF32 off): the loss to rtol 1e-5; the parameters within atol 1e-5 except
# at most 1e-4 of the entries, and those within 2 x lr: AdamW's first step
# divides each gradient entry by its own magnitude, so an entry that is
# rounding noise (the sums over ranks run in another order) moves by up to
# lr either way.
MESH_LOSS_RTOL, MESH_PARAM_ATOL, MESH_PARAM_FRAC = 1e-5, 1e-5, 1e-4
# the fused norm (kernels.norm) in f32: the kernel sums a row in another
# order than ATen's reduction, so outputs differ in the last f32 bits;
# outputs near 0 (LayerNorm near a row's mean, a bias cancelling the scaled
# value) carry a few f32 ulps of the O(1) terms, hence the atol.  In bf16
# the norm is held to 1 ulp, except a LayerNorm output that is such a
# difference of nearly equal terms: one ulp of its own small magnitude is
# finer than those f32 ulps, so it is held to NORM_BF16_CANCEL absolute.
# RoPE, the cache writes, the residual sums and the activations are held
# bit for bit (phase 3).
NORM_F32 = dict(rtol=1e-6, atol=1e-6)
NORM_BF16_CANCEL = 2.0**-16
# decode (kernel) against prefill (plain) through 2 full-width f32 layers
# and the 151936-wide head: summation order over d_model 2048 and d_ff 6144.
MODEL_F32 = dict(rtol=1e-3, atol=1e-3)
# the train loss against the cross-entropy of the forward logits: the same
# f32 logits summed in chunks or at once (f32); in bf16 the head's matmul
# over a chunk and over the whole sequence may round differently
LOSS_F32, LOSS_BF16 = dict(rtol=1e-5, atol=0.0), dict(rtol=1e-2, atol=0.0)
# the card's train step against the CPU's (f32, TF32 off): the loss to
# rtol 1e-4; each leaf's f32 first moment (0.1 x the clipped gradient) to
# 1e-4 of its norm; the updated parameters entrywise within 1e-5 except
# where a gradient entry is rounding noise (|g| near eps, where the first
# Adam step's sign may differ: at most 2.2 x lr apart), at most 1e-3 of a
# leaf's entries
STEP_LOSS_RTOL, STEP_MU_RTOL, STEP_PARAM_ATOL, STEP_PARAM_FRAC = 1e-4, 1e-4, 1e-5, 1e-3

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


def profiled_ms(torch, fn, flush=None, calls=20):
    """Device time of one ``fn()`` by ``torch.profiler``: the summed
    durations of the device ops one call runs, averaged over ``calls``
    calls.  With ``flush`` (a buffer) each call follows a write of it, as in
    ``time_ms``, and that write's kernel is not counted.  None where the
    profiler traced no device op (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def spans(body):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == DeviceType.CUDA)

    alone = spans(fn)
    if not alone:
        return None
    if flush is None:
        def body():
            for _ in range(calls):
                fn()
        got = spans(body)
        return sum(b - a for a, b in got) / calls / 1e3
    per_call = len(alone)

    def body():
        for _ in range(calls):
            flush.zero_()
            fn()
    got = spans(body)
    need(len(got) == calls * (1 + per_call),
         f"profiler: {len(got)} device ops for {calls} x (flush + {per_call})")
    keep = [s for i, s in enumerate(got) if i % (1 + per_call)]  # each call's flush first
    return sum(b - a for a, b in keep) / calls / 1e3


def graph_ms(torch, fn, n=57, replays=10):
    """Mean ms of one ``fn()`` among ``n`` back to back in one captured CUDA
    graph (a replayed step runs each norm 57 times), replayed ``replays``
    times with CUDA events around all of them; no flush, as in the step,
    where each call's input is the previous kernel's output."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (replays * n)
    del g
    torch.cuda.empty_cache()
    return ms


def three_ways(torch, dev, fn):
    """(a) ``time_ms``: CUDA events around one call after the L2 flush;
    (b) the profiler's device time of one call after the flush, and (b')
    of one call back to back without it; (c) one of 57 calls in a
    captured graph.  Returns a dict of the four, in ms."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    out = {"a": time_ms(torch, dev, fn, iters=50), "b": profiled_ms(torch, fn, flush),
           "b_warm": profiled_ms(torch, fn), "c": graph_ms(torch, fn)}
    del flush
    return out


def fmt_ways(w):
    us = lambda ms: "not measured" if ms is None else f"{1e3 * ms:.2f} us"  # noqa: E731
    return (f"(a) events after flush {us(w['a'])}, (b) profiler after flush {us(w['b'])}, "
            f"(b') profiler back to back {us(w['b_warm'])}, (c) 1 of 57 in a graph {us(w['c'])}")


def bound(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# kernel comparisons
# ---------------------------------------------------------------------------


def check_ivf(torch, ops, ref, q, gc, slab, valid, k, tol, what, span=None):
    """Kernel against plain on one input; returns (max_abs_err, boundary ties).
    ``span`` forces the kernel's rows per block.

    Only real query rows are compared: the all-zero rows that pad a group to
    QB see every row of the cluster at one distance, all ties."""
    dk, ik = ops.ivf_scan(q, gc, slab, valid, k, _span=span)
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


def check_attn(torch, ops, ref, q, k, v, lengths, tol, what, chunk=None):
    """Kernel against plain; ``chunk`` forces the kernel's cache rows per block."""
    out = ops.decode_attention(q, k, v, lengths, _chunk=chunk)
    torch.cuda.synchronize()
    exp = ref.decode_attention_ref(q, k, v, lengths)
    err = float((out.float() - exp.float()).abs().max())
    ok = bool(torch.allclose(out.float(), exp.float(), **tol))
    log(f"  decode_attention {what}: max_abs_err={err:.3e} "
        f"(rtol={tol['rtol']}, atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
    need(ok and torch.isfinite(out).all(), f"decode_attention {what} disagrees with the plain version")
    return err


def check_attn_lse(torch, ops, ref, q, k, v, lengths, tol, what, chunk=None):
    """The kernel's (output, log-sum-exp) against the plain version's; a
    length of 0 must give zeros and -inf."""
    out, lse = ops.decode_attention(q, k, v, lengths, return_lse=True, _chunk=chunk)
    torch.cuda.synchronize()
    exp, exp_lse = ref.decode_attention_ref(q, k, v, lengths, return_lse=True)
    err = float((out.float() - exp.float()).abs().max())
    empty = lengths == 0
    fin = ~empty[:, None].expand_as(lse)
    lse_err = float((lse[fin] - exp_lse[fin]).abs().max())
    ok = (bool(torch.allclose(out.float(), exp.float(), **tol))
          and bool(torch.allclose(lse[fin], exp_lse[fin], **ATTN_LSE))
          and bool(torch.isneginf(lse[~fin]).all()) and bool((out[empty] == 0).all()))
    log(f"  decode_attention {what}: out max_abs_err={err:.3e}, lse max_abs_err={lse_err:.3e} "
        f"(rtol={ATTN_LSE['rtol']}, atol={ATTN_LSE['atol']}), length 0 -> -inf "
        f"{'ok' if ok else 'FAIL'}")
    need(ok, f"decode_attention {what}: the log-sum-exp output disagrees with the plain version")
    return max(err, lse_err)


def same_bits_twice(torch, fn, what):
    """Two calls on one input give the same bits (the split kernels combine
    their blocks in split order, whichever block finishes last)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    same = all(torch.equal(x.view(bits[x.element_size()]), y.view(bits[y.element_size()]))
               for x, y in zip(a, b))
    log(f"  {what}: two calls {'bit-identical' if same else 'DIFFER'}")
    need(same, f"{what}: two calls on one input differ")


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
    # forced small spans (a cluster's rows over up to 32 blocks): valid 0, 1,
    # L and at and around split edges, on the same real clusters
    for span in (24, 37, 100):
        ev = t["valid"].clone()
        ev[:6] = torch.tensor([0, 1, tile_len, span, span + 1, 2 * span - 1], device=dev)
        e, n = check_ivf(torch, ivf_ops, ivf_ref, t["q"], t["gc"], t["slab"], ev, 10, F32,
                         f"span={span} k=10 valid 0/1/L/edges", span=span)
        errs.append(e)
        ties += n
    # identical rows straddling a split edge, nearer than any other row
    # (small integers: exact distances, exact ties): the lower rows win
    span = 24
    tie = torch.arange(span - 3, span + 3, device=dev)
    edge = torch.as_tensor(rng.integers(3, 6, size=(1, tile_len, index.dim)), dtype=torch.float32,
                           device=dev)
    edge[:, tie] = 1.0
    ed, ei = ivf_ops.ivf_scan(dq[:1], dgc[:1], edge, dvalid[:1], 6, _span=span)
    torch.cuda.synchronize()
    need(torch.equal(ei[0].cpu(), tie.int().cpu().expand(QB, 6)) and bool((ed == index.dim).all()),
         f"ivf_scan ties across a split edge: got ids {ei[0, 0].tolist()}")
    log(f"  ivf_scan identical rows {tie.tolist()} across the edge of span {span}: ids in row order")
    same_bits_twice(torch, lambda: ivf_ops.ivf_scan(t["q"], t["gc"], t["slab"], t["valid"], 5),
                    "ivf_scan default span")
    same_bits_twice(torch, lambda: ivf_ops.ivf_scan(t["q"], t["gc"], t["slab"], t["valid"], 24,
                                                   _span=37), "ivf_scan span=37 k=24")
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
    # each family's full-width decode shape in bf16, B 8, lengths 1 to S
    for arch, H, KV, dh, S in ATTN_SHAPES:
        q, k, v = make(8, H, KV, dh, S, torch.bfloat16)
        lengths = torch.tensor([1, 2, 31, 33, 517, 1024, S - 1, S], dtype=torch.int32, device=dev)
        errs.append(check_attn(torch, attn_ops, attn_ref, q, k, v, lengths, ATTN_BF16,
                               f"{arch} B=8 H={H} KV={KV} dh={dh} S={S} bf16"))
    # forced small chunks (the cache over many blocks): lengths 1, S and at
    # and around chunk edges; G = 10, two head groups a kv head
    B, H, KV, dh, S = 8, 20, 2, 64, 300
    for chunk in (1, 7, 32, 100):
        lengths = torch.tensor([1, S, chunk, chunk + 1, max(1, chunk - 1), 2 * chunk,
                                3 * chunk + 1, S - 1], dtype=torch.int32, device=dev).clamp(1, S)
        for dtype, tol in ((torch.float32, F32), (torch.bfloat16, ATTN_BF16)):
            q, k, v = make(B, H, KV, dh, S, dtype)
            errs.append(check_attn(torch, attn_ops, attn_ref, q, k, v, lengths, tol,
                                   f"chunk={chunk} lengths={lengths.tolist()} {str(dtype)[6:]}",
                                   chunk=chunk))
    # a length of 0 gives zeros (acc / max(l, 1e-30)), split or not
    q, k, v = make(2, 4, 2, 64, 64, torch.float32)
    zl = torch.tensor([0, 64], dtype=torch.int32, device=dev)
    for chunk in (None, 7):
        out = attn_ops.decode_attention(q, k, v, zl, _chunk=chunk)
        torch.cuda.synchronize()
        need(bool((out[0] == 0).all()), f"decode_attention length 0 (chunk={chunk}): not zeros")
    log("  decode_attention length 0: zeros (default chunk and chunk=7)")
    # the log-sum-exp output, at the qwen3 shape (one chunk and split), at
    # forced chunks, and -inf for a length of 0
    q, k, v = make(8, 16, 8, 128, 2048, torch.bfloat16)
    lengths = torch.tensor([0, 1, 31, 33, 517, 1024, 2047, 2048], dtype=torch.int32, device=dev)
    for chunk in (None, 2048, 7):
        errs.append(check_attn_lse(torch, attn_ops, attn_ref, q, k, v, lengths, ATTN_BF16,
                                   f"lse qwen3 shape bf16 chunk={chunk or 'default'}", chunk))
    q, k, v = make(3, 20, 2, 64, 300, torch.float32)
    lengths = torch.tensor([0, 150, 300], dtype=torch.int32, device=dev)
    errs.append(check_attn_lse(torch, attn_ops, attn_ref, q, k, v, lengths, F32,
                               "lse G=10 f32 chunk=32", 32))
    q, k, v = make(8, 16, 8, 128, 2048, torch.bfloat16)
    lengths = torch.tensor([1, 127, 128, 129, 1057, 1500, 2047, 2048], dtype=torch.int32, device=dev)
    for chunk in (None, 32):
        same_bits_twice(torch, lambda: attn_ops.decode_attention(q, k, v, lengths, _chunk=chunk),
                        f"decode_attention qwen3-1.7b shape chunk={chunk or 'default'}")
    return max(errs)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_merge(torch, ops, ref, args, what, chunk=None):
    """Kernel against plain, bit for bit (the merge does no arithmetic);
    returns the largest |difference| of the finite distances (0.0).
    ``chunk`` forces the kernel's chunk of keys."""
    dk, ik = ops.topk_merge(*args, _chunk=chunk)
    sync(torch, dk.device)
    dr, ir = ref.topk_merge_ref(*args)
    same = (ik.dtype == args[1].dtype and torch.equal(dk.view(torch.int32), dr.view(torch.int32))
            and torch.equal(ik, ir))
    if not same:
        log(f"  topk_merge {what}: {int((dk != dr).sum())} distances and "
            f"{int((ik != ir).sum())} ids differ")
    need(same, f"topk_merge {what}: not equal to the plain version bit for bit")
    fin = torch.isfinite(dr)
    return float((dk[fin] - dr[fin]).abs().max()) if bool(fin.any()) else 0.0


def merge_inputs(torch, gen, Q, k, m, id_dtype, dev):
    """Half-filled ascending scoreboards; candidates that repeat running
    distances, with NaN, -inf and +inf injected; ids of ``id_dtype``."""
    rd = torch.rand((Q, k), generator=gen, device=dev).sort(dim=1).values
    rd[:, (k + 1) // 2:] = float("inf")
    cd = torch.rand((Q, m), generator=gen, device=dev)
    dup = torch.rand((Q, m), generator=gen, device=dev) < 0.2
    cd = torch.where(dup, torch.gather(rd, 1, torch.randint(0, k, (Q, m), generator=gen,
                                                            device=dev)), cd)
    special = torch.tensor([float("nan"), -float("inf"), float("inf")], device=dev)
    bad = torch.rand((Q, m), generator=gen, device=dev) < 0.1
    cd = torch.where(bad, special[torch.randint(0, 3, (Q, m), generator=gen, device=dev)], cd)
    ri = torch.randint(0, 2**31 - 1, (Q, k), generator=gen, device=dev, dtype=id_dtype)
    ci = torch.randint(0, 2**31 - 1, (Q, m), generator=gen, device=dev, dtype=id_dtype)
    return rd, ri, cd, ci


def merge_cases(torch, merge_ops, merge_ref, dev):
    """topk_merge over k x m x Q x id type, forced chunks, k past the
    register path up to the limit, long rows, the tie / +inf-slot rules, and
    two calls on one input."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    errs = []
    for Q in (1, 13, 8192):
        for k in (1, 5, 10, 24, 32, 33, 64, 128):
            for m in (1, 3 * k, 1024):
                for idt in (torch.int32, torch.int64):
                    args = merge_inputs(torch, gen, Q, k, m, idt, dev)
                    errs.append(check_merge(torch, merge_ops, merge_ref, args,
                                            f"Q={Q} k={k} m={m} ids={str(idt)[6:]}"))
    # rows streamed through forced chunks of 32..256 keys (a chunk holds k)
    n_forced = 0
    for chunk in (32, 64, 128, 256):
        for k in (1, 10, 32, 64, 200):
            for m in (30, 1024):
                if k <= chunk:
                    args = merge_inputs(torch, gen, 13, k, m, torch.int64, dev)
                    errs.append(check_merge(torch, merge_ops, merge_ref, args,
                                            f"chunk={chunk} k={k} m={m}", chunk=chunk))
                    n_forced += 1
    # k > 256 (the list in shared memory) up to the limit, the previous
    # kernel's largest row (2k + m = 14,528), and a row of 20,000 candidates
    kmax = merge_ops._lib().topk_merge_max_row()
    big = ((3, 257, 1), (5, 300, 1024), (2, 1000, 96), (2, 7000, 528), (2, kmax, 100),
           (4, 8, 20_000))
    for Q, k, m in big:
        args = merge_inputs(torch, gen, Q, k, m, torch.int32, dev)
        errs.append(check_merge(torch, merge_ops, merge_ref, args, f"Q={Q} k={k} m={m}"))
    over = merge_inputs(torch, gen, 1, kmax + 1, 1, torch.int32, dev)
    try:
        merge_ops.topk_merge(*over)
        need(False, f"topk_merge took k={kmax + 1}, over its limit")
    except ValueError:
        pass
    # ties go to the running entries; NaN and -inf sort last as +inf; the
    # +inf slots keep the non-finite entries' ids in position order
    run_d = torch.tensor([[0.5, 0.5, float("inf"), float("inf")]], device=dev)
    run_i = torch.tensor([[1, 2, 3, 4]], device=dev)
    cand_d = torch.tensor([[0.5, float("nan"), -float("inf"), 0.25]], device=dev)
    cand_i = torch.tensor([[5, 6, 7, 8]], device=dev)
    d, i = merge_ops.topk_merge(run_d, run_i, cand_d, cand_i)
    need(d.tolist() == [[0.25, 0.5, 0.5, 0.5]] and i.tolist() == [[8, 1, 2, 5]],
         f"topk_merge ties: got {d.tolist()} {i.tolist()}")
    d, i = merge_ops.topk_merge(run_d[:, 2:], run_i[:, 2:], cand_d[:, 1:3], cand_i[:, 1:3])
    need(bool(torch.isinf(d).all()) and i.tolist() == [[3, 4]],
         f"topk_merge +inf slots: got {d.tolist()} {i.tolist()}")
    for Q, k, m, chunk in ((POD_Q, POD_K, POD_M, None), (13, 32, 1024, 32), (5, 600, 96, None)):
        args = merge_inputs(torch, gen, Q, k, m, torch.int64, dev)
        same_bits_twice(torch, lambda: merge_ops.topk_merge(*args, _chunk=chunk),
                        f"topk_merge Q={Q} k={k} m={m} chunk={chunk or 'default'}")
    log(f"  topk_merge: {len(errs)} cases (Q 1/13/8192, k 1..128, m 1/3k/1024, int32/int64 ids, "
        f"half-filled boards, NaN/-inf/+inf, duplicates; {n_forced} with forced chunks of "
        f"32-256 keys; k 257..{kmax} and m 20,000) equal to the plain version bit for bit; "
        f"k={kmax + 1} refused; ties to the running entries, +inf-slot ids in position order")
    return max(errs)


# ---------------------------------------------------------------------------
# the fused kernels of the model body (norm, qk_rope, glu)
# ---------------------------------------------------------------------------


def bits_equal(torch, a, b) -> bool:
    view = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def bf16_steps(torch, a, b):
    """Per element, how many bf16 values apart two bf16 tensors lie."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


def check_norm_out(torch, got, want, what, layernorm=False):
    """A norm's output against the plain version's: within 1 ulp in bf16
    (a LayerNorm output past 1 ulp within NORM_BF16_CANCEL; NORM_F32 in
    f32); prints the largest error and the share of elements that differ.
    Returns the largest |difference|."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if got.numel() else 0.0
    share = float((got != want).float().mean()) if got.numel() else 0.0
    if got.dtype == torch.bfloat16:
        steps = bf16_steps(torch, got, want)
        over = steps > 1
        n_over = int(over.sum())
        ok = n_over == 0 or (layernorm and bool((diff[over] <= NORM_BF16_CANCEL).all()))
        tol = f"{int(steps.max()) if got.numel() else 0} ulp (<= 1"
        tol += f"; {n_over} cancelling outputs within {NORM_BF16_CANCEL:.2e})" if layernorm else ")"
    else:
        ok, tol = bool(torch.allclose(got, want, **NORM_F32)), f"rtol {NORM_F32['rtol']}, atol {NORM_F32['atol']}"
    log(f"  {what}: max_abs_err={err:.3e}, {tol}, {100 * share:.3f}% of elements differ "
        f"{'ok' if ok else 'FAIL'}")
    need(ok, f"{what}: the kernel is not within its tolerance of the plain version")
    return err


def rand(torch, gen, shape, dtype, dev, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)


def norm_cases(torch, dev):
    """kernels.norm against its plain version: RMSNorm and LayerNorm, with
    and without the residual add, at the main path's shapes (decode 8 x 2048,
    prefill 1024 x 2048, bf16) and at every family's width in bf16 and in
    f32 (phase 11's dtype), over the kernel's three layouts: lane groups
    (d_head-wide and MLA's 512-wide rows), one warp a row (up to 2,048 bf16
    or 1,024 f32 values) and a few warps a row (recurrentgemma's 2,560,
    phi3's 3,072, llama4's and stablelm's 5,120, qwen1.5's 8,192, and 16,384
    to 32,768, the kernel's limit); odd row counts, a strided row (MLA's
    latent) and f32 parameters under bf16 activations; the residual sum bit
    for bit; two calls on one input bit for bit."""
    from repro_torch.kernels.norm import norm, norm_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)
    bf, f32 = torch.bfloat16, torch.float32
    rms, ln = "rmsnorm", "layernorm"
    cases = [  # rows, d, activations' dtype, kind[, parameters' dtype]
        (8, 2048, bf, rms), (1024, 2048, bf, rms), (1023, 2048, bf, ln),  # the main path
        (37, 64, bf, rms), (29, 128, bf, rms), (9, 256, f32, rms), (13, 512, bf, rms),  # groups
        (7, 1024, bf, ln), (5, 1024, f32, ln), (8, 2048, f32, rms), (1, 256, bf, rms),  # a warp
        (7, 2560, bf, rms), (7, 3072, bf, rms), (9, 5120, bf, ln), (1, 8192, bf, rms),  # warps
        (3, 2560, f32, rms), (3, 3072, f32, rms), (3, 5120, f32, ln), (3, 8192, f32, rms),
        (2, 16384, f32, rms), (2, 32768, f32, ln), (2, 32768, bf, rms),
        (4, 2048, bf, ln, f32), (3, 64, f32, rms, bf)]  # parameters of the other dtype
    errs = []
    for rows, d, dt, kind, *pdt in cases:
        pdt = pdt[0] if pdt else dt
        x, delta = rand(torch, gen, (rows, d), dt, dev), rand(torch, gen, (rows, d), dt, dev)
        scale = rand(torch, gen, (d,), pdt, dev, 0.1, 1.0)
        bias = rand(torch, gen, (d,), pdt, dev, 0.1) if kind == "layernorm" else None
        for residual in (False, True):
            kw = dict(kind=kind, eps=1e-6, delta=delta if residual else None)
            got, want = norm(x, scale, bias, **kw), norm_ref(x, scale, bias, **kw)
            torch.cuda.synchronize()
            what = (f"norm {kind} {rows}x{d} {str(dt)[6:]}"
                    f"{'' if pdt == dt else f' ({str(pdt)[6:]} parameters)'}"
                    f"{' + residual' if residual else ''}")
            if residual:
                need(bits_equal(torch, got[0], want[0]), f"{what}: the residual sum differs")
                got, want = got[1], want[1]
            errs.append(check_norm_out(torch, got, want, what, kind == "layernorm"))
    # MLA's latent: a slice of a wider product, rows 576 apart; f32 scale
    wide = rand(torch, gen, (4, 33, 576), bf, dev)
    scale = rand(torch, gen, (512,), f32, dev, 0.1, 1.0)
    errs.append(check_norm_out(torch, norm(wide[..., :512], scale, eps=1e-6),
                               norm_ref(wide[..., :512], scale, eps=1e-6),
                               "norm rmsnorm strided 4x33x512 of 576 bf16, f32 scale"))
    x, delta = rand(torch, gen, (8, 2048), bf, dev), rand(torch, gen, (8, 2048), bf, dev)
    scale = rand(torch, gen, (2048,), bf, dev, 0.1, 1.0)
    same_bits_twice(torch, lambda: norm(x, scale, eps=1e-6, delta=delta),
                    "norm decode shape + residual")
    return max(errs)


def check_qk_rope_case(torch, gen, dev, B, S, H, KV, dh, dt, what, cache=None,
                       unaligned=False):
    """One qk_rope input through the kernel and the plain version: RoPE
    alone bit for bit; the qk-norm alone within its tolerance; qk-norm +
    RoPE equal to the plain RoPE of the kernel's own qk-norm output, bit for
    bit; with ``cache`` = (rows, cache_len, window) the decode write too,
    equal to the plain write of the kernel's own k.  ``unaligned``: q and k
    start one element past a 16-byte boundary (the kernel's scalar
    accesses).  Returns the qk-norm's largest error."""
    from repro_torch.kernels.qk_rope import apply_rope_ref, qk_rope, qk_rope_ref, scatter_time_ref

    def heads(n):
        t = rand(torch, gen, (B * S * n * dh + 1,), dt, dev)
        return t[int(unaligned):][:B * S * n * dh].view(B, S, n, dh)

    q, k = heads(H), heads(KV)
    qs, ks = rand(torch, gen, (dh,), dt, dev, 0.1, 1.0), rand(torch, gen, (dh,), dt, dev, 0.1, 1.0)
    if cache is None:
        pos = torch.arange(S, device=dev)[None].expand(B, S)  # int64, the prefill's
    else:
        pos = cache[1][:, None]  # int32 cache_len, the decode's
    theta = 1e6
    got, want = qk_rope(q, k, pos, theta=theta), qk_rope_ref(q, k, pos, theta=theta)
    torch.cuda.synchronize()
    need(all(bits_equal(torch, a, b) for a, b in zip(got, want)), f"{what}: RoPE differs")
    normed = qk_rope(q, k, q_scale=qs, k_scale=ks)
    want = qk_rope_ref(q, k, q_scale=qs, k_scale=ks)
    err = max(check_norm_out(torch, a, b, f"{what} qk-norm of {n}")
              for a, b, n in zip(normed, want, "qk"))
    both = qk_rope(q, k, pos, theta=theta, q_scale=qs, k_scale=ks)
    need(all(bits_equal(torch, a, apply_rope_ref(n, pos, theta)) for a, n in zip(both, normed)),
         f"{what}: qk-norm + RoPE differs from RoPE of the kernel's qk-norm")
    note = ""
    if cache is not None:
        rows, cache_len, window = cache
        slot = cache_len % window if window else cache_len
        v = rand(torch, gen, (B, 1, KV, dh), dt, dev)
        kc, vc = rand(torch, gen, (B, rows, KV, dh), dt, dev), rand(torch, gen, (B, rows, KV, dh), dt, dev)
        kr, vr = kc.clone(), vc.clone()
        _, k_out = qk_rope(q, k, pos, theta=theta, q_scale=qs, k_scale=ks, v=v, k_cache=kc,
                           v_cache=vc, slot=slot)
        scatter_time_ref(kr, k_out, slot)
        scatter_time_ref(vr, v, slot)
        torch.cuda.synchronize()
        need(bits_equal(torch, kc, kr) and bits_equal(torch, vc, vr),
             f"{what}: the cache write differs from the plain write")
        note = f", cache write at slots {slot.tolist()} of {rows} rows equal"
    log(f"  {what}: RoPE (positions {int(pos.min())}..{int(pos.max())}) bit for bit, "
        f"qk-norm + RoPE equal to RoPE of its qk-norm{note}")
    return err


def qk_rope_cases(torch, dev):
    """kernels.qk_rope against its plain version at the main path's decode
    and prefill shapes (qwen3-1.7b, bf16), d_head 64 / 96 / 128 / 160 / 256,
    odd token counts, f32, a ring slot, position 0 and a position past the
    cache's end (clamped to the last row); the kernel's scalar accesses (d_head
    100, whose halves are no whole number of 16-byte vectors, and heads one
    element off a 16-byte boundary); phi3's prefill (32 + 32 heads of 96)."""
    from repro_torch.kernels.qk_rope import qk_rope

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)
    bf, f32 = torch.bfloat16, torch.float32
    i32 = dict(dtype=torch.int32, device=dev)
    lens = torch.tensor([0, 1, 517, 1024, 2046, 2047, 2048, 3000], **i32)
    errs = [check_qk_rope_case(torch, gen, dev, 8, 1, 16, 8, 128, bf, "qk_rope decode "
                               "(8,1,16|8,128) bf16", (MAX_LEN, lens, 0)),
            check_qk_rope_case(torch, gen, dev, 1, 1024, 16, 8, 128, bf,
                               "qk_rope prefill (1,1024,16|8,128) bf16")]
    for dh in (64, 96, 128, 160, 256):
        for dt in (bf, f32):
            errs.append(check_qk_rope_case(
                torch, gen, dev, 3, 1, 8, 2, dh, dt, f"qk_rope decode dh={dh} {str(dt)[6:]}",
                (300, torch.tensor([0, 299, 4000], **i32), 0)))
            errs.append(check_qk_rope_case(torch, gen, dev, 2, 37, 8, 2, dh, dt,
                                           f"qk_rope S=37 dh={dh} {str(dt)[6:]}"))
    # a ring cache (recurrentgemma's local attention: slot cache_len % window)
    errs.append(check_qk_rope_case(torch, gen, dev, 4, 1, 10, 1, 256, bf,
                                   "qk_rope ring dh=256 bf16",
                                   (2048, torch.tensor([5, 2047, 2048, 4101], **i32), 2048)))
    # the scalar accesses: halves that are no whole number of vectors, and
    # unaligned heads; and the prefill's token count at phi3's 32 + 32 heads
    for dt in (bf, f32):
        errs.append(check_qk_rope_case(torch, gen, dev, 3, 1, 5, 3, 100, dt,
                                       f"qk_rope decode dh=100 {str(dt)[6:]}",
                                       (64, torch.tensor([0, 63, 64], **i32), 0)))
        errs.append(check_qk_rope_case(torch, gen, dev, 2, 9, 4, 2, 128, dt,
                                       f"qk_rope S=9 dh=128 unaligned {str(dt)[6:]}",
                                       unaligned=True))
    errs.append(check_qk_rope_case(torch, gen, dev, 1, 1024, 32, 32, 96, bf,
                                   "qk_rope prefill (1,1024,32|32,96) bf16"))
    q, k = rand(torch, gen, (8, 1, 16, 128), bf, dev), rand(torch, gen, (8, 1, 8, 128), bf, dev)
    s = rand(torch, gen, (128,), bf, dev, 0.1, 1.0)
    pos = lens[:, None]
    same_bits_twice(torch, lambda: qk_rope(q, k, pos, theta=1e6, q_scale=s, k_scale=s),
                    "qk_rope decode shape")
    return max(errs)


def glu_cases(torch, dev):
    """kernels.glu against its plain version, bit for bit: SiLU and GELU at
    the main path's decode and prefill shapes (qwen3-1.7b's d_ff 6144),
    GeGLU's widths (paligemma 16384), deepseek's experts (64 x C x 1408),
    f32, inputs from -30 to 30, and a ragged tail past the 16-byte vectors."""
    from repro_torch.kernels.glu import glu, glu_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 32)
    bf, f32 = torch.bfloat16, torch.float32
    shapes = [((8, 1, 6144), bf), ((1, 1024, 6144), bf), ((8, 1, 16384), bf),
              ((64, 24, 1408), bf), ((8, 1, 6144), f32), ((3, 5, 1365), bf), ((2, 4099), f32)]
    n = 0
    for kind in ("silu", "gelu"):
        for shape, dt in shapes:
            a, b = rand(torch, gen, shape, dt, dev, 4.0), rand(torch, gen, shape, dt, dev)
            got = glu(a, b, kind=kind)
            torch.cuda.synchronize()
            want = glu_ref(a, b, kind=kind)
            if not bits_equal(torch, got, want):
                bad = got != want
                log(f"  glu {kind} {shape} {str(dt)[6:]}: {int(bad.sum())} of {got.numel()} "
                    f"differ, e.g. a={a[bad][:4].tolist()} kernel={got[bad][:4].tolist()} "
                    f"plain={want[bad][:4].tolist()}")
            need(bits_equal(torch, got, want), f"glu {kind} {shape}: differs from the plain version")
            n += 1
        sweep = torch.linspace(-30, 30, 8 * 4099, device=dev)
        for dt in (bf, f32):
            a = sweep.to(dt)
            need(bits_equal(torch, glu(a, a, kind=kind), glu_ref(a, a, kind=kind)),
                 f"glu {kind} over -30..30 {str(dt)[6:]}: differs from the plain version")
            n += 1
    a, b = rand(torch, gen, (8, 1, 6144), bf, dev), rand(torch, gen, (8, 1, 6144), bf, dev)
    same_bits_twice(torch, lambda: glu(a, b), "glu decode shape")
    log(f"  glu: {n} cases (silu and gelu; decode, prefill, GeGLU, MoE experts, f32, "
        f"-30..30, ragged tails) equal to the plain version bit for bit")
    return 0.0


def fused_inputs(torch, dev, B, S):
    """Seeded inputs of the three fused kernels at qwen3-1.7b's shapes for
    B x S tokens (decode: B 8, S 1, the caches 2048 rows, cache_len near
    phase 4's 1,055; prefill: B 1, S 1024)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 33)
    bf = torch.bfloat16
    d, H, KV, dh, ff = 2048, 16, 8, 128, 6144
    x, delta = rand(torch, gen, (B, S, d), bf, dev), rand(torch, gen, (B, S, d), bf, dev)
    scale = rand(torch, gen, (d,), bf, dev, 0.1, 1.0)
    q, k, v = (rand(torch, gen, (B, S, n, dh), bf, dev) for n in (H, KV, KV))
    qs, ks = (rand(torch, gen, (dh,), bf, dev, 0.1, 1.0) for _ in range(2))
    rope = dict(theta=1e6, q_scale=qs, k_scale=ks)
    if S == 1:
        cache_len = torch.tensor([1000, 1024, 1100, 1050, 1080, 1010, 1090, 1060],
                                 dtype=torch.int32, device=dev)[:B]
        pos = cache_len[:, None]
        caches = [rand(torch, gen, (B, MAX_LEN, KV, dh), bf, dev) for _ in range(2)]
        rope.update(v=v, k_cache=caches[0], v_cache=caches[1], slot=cache_len)
    else:
        pos = torch.arange(S, device=dev)[None].expand(B, S)
    a, b = rand(torch, gen, (B, S, ff), bf, dev, 4.0), rand(torch, gen, (B, S, ff), bf, dev)
    return {"norm": (x, delta, scale), "qk_rope": (q, k, pos, rope), "glu": (a, b)}


def time_fused(torch, dev):
    """Phase 6: each fused kernel at its decode and prefill shapes: CUDA-event
    time, its plain version's, one PyTorch call where one computes the same
    function (F.rms_norm for the norm), the byte bound at the card's memory
    rate and one torch.sum over as many bytes.  Returns the decode shape's
    numbers for the kernels line."""
    import torch.nn.functional as F

    from repro_torch.kernels.glu import glu, glu_ref
    from repro_torch.kernels.norm import norm, norm_ref
    from repro_torch.kernels.qk_rope import qk_rope, qk_rope_ref

    out = {}
    # the card idles while the host frees the twin engine; bring its clocks
    # up before the first timing, as phase 6's first line does
    tiny = torch.zeros(1, device=dev)
    log(f"  timing floor: a one-element kernel {time_ms(torch, dev, lambda: tiny.add_(1), iters=50):.4f} ms")
    for label, B, S in (("decode", 8, 1), ("prefill", 1, 1024)):
        inp = fused_inputs(torch, dev, B, S)
        x, delta, scale = inp["norm"]
        d = x.shape[-1]
        rows = x.numel() // d
        esz = x.element_size()
        q, k, pos, rope = inp["qk_rope"]
        a, b = inp["glu"]
        qk_bytes = 2 * (q.numel() + k.numel()) * esz + 2 * q.shape[-1] * esz + pos.numel() * pos.element_size()
        if "v_cache" in rope:  # v read; the k and v rows written
            qk_bytes += 3 * rope["v"].numel() * esz + 4 * B
        runs = {
            # name: (kernel, plain, library or None, bytes, f32 ops)
            "norm": (lambda: norm(x, scale, eps=1e-6), lambda: norm_ref(x, scale, eps=1e-6),
                     lambda: F.rms_norm(x, (d,), weight=scale, eps=1e-6),
                     2 * x.numel() * esz + d * esz, 4 * x.numel()),
            "norm + residual": (lambda: norm(x, scale, eps=1e-6, delta=delta),
                                lambda: norm_ref(x, scale, eps=1e-6, delta=delta), None,
                                4 * x.numel() * esz + d * esz, 5 * x.numel()),
            "qk_rope": (lambda: qk_rope(q, k, pos, **rope), lambda: qk_rope_ref(q, k, pos, **rope),
                        None, qk_bytes, 14 * (q.numel() + k.numel())),
            "glu": (lambda: glu(a, b), lambda: glu_ref(a, b), None, 3 * a.numel() * esz,
                    6 * a.numel()),
        }
        for name, (kern, plain, lib, n_bytes, n_ops) in runs.items():
            b_ms, b_by = bound(n_bytes, n_ops, F32_FLOPS)
            ms = time_ms(torch, dev, kern, iters=50)
            plain_ms = time_ms(torch, dev, plain, iters=20)
            lib_ms = time_ms(torch, dev, lib, iters=50) if lib is not None else None
            floor = read_floor_ms(torch, dev, n_bytes)
            lib_txt = f"{lib_ms:.4f} ms (F.rms_norm)" if lib_ms is not None else "none"
            log(f"  {name} {label} ({rows} rows x {d}; q {tuple(q.shape)}, glu {tuple(a.shape)}):"
                f" {n_bytes} bytes, {n_ops} f32 ops; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {lib_txt}, bound {b_ms:.4f} ms ({b_by}); one torch.sum over as many "
                f"bytes {floor:.4f} ms")
            if name != "glu":  # the three measures of a launch (PERF.md section 5)
                log(f"    {name} {label} kernel: {fmt_ways(three_ways(torch, dev, kern))}")
                if lib is not None:
                    log(f"    {name} {label} F.rms_norm: {fmt_ways(three_ways(torch, dev, lib))}")
            if label == "decode" and name in ("norm", "qk_rope", "glu"):
                out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": lib_ms}
        del inp
    return out


def plain_chain_twin(torch, dev, engine):
    """A second engine over ``engine``'s parameters, built under the
    plain-on-card switch, so its decode graph records the plain chains (the
    model body before the fused kernels), with ``engine``'s state copied in."""
    from repro_torch.kernels._plain import plain_on_card
    from repro_torch.serving.engine import GenerationEngine

    with plain_on_card():
        twin = GenerationEngine(engine.cfg, engine.params, max_batch=engine.max_batch,
                                max_len=engine.max_len, eos_id=engine.eos_id, device=dev)
    for dst, src in zip(twin._buffers(), engine._buffers(), strict=True):
        dst.copy_(src)
    twin.free_slots = list(engine.free_slots)
    return twin


def first_difference(a, b):
    """(sequence, step) of the first token where two lists of streams differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        for t, (u, w) in enumerate(zip(x, y)):
            if u != w:
                return i, t
        if len(x) != len(y):
            return i, min(len(x), len(y))
    return None


def teacher_forced(torch, dev, cfg, params, padded, tokens, steps):
    """Logits (B 1) of the prefill of ``padded`` and of ``steps`` decode steps
    fed ``tokens``, each step's as f32 on the card."""
    from repro_torch.models import lm

    toks = torch.as_tensor(padded, dtype=torch.int64, device=dev)[None]
    logits, state = lm.prefill(params, cfg, toks, max_len=MAX_LEN)
    out = [logits[0]]
    for t in range(steps):
        logits, state = lm.decode_step(params, cfg, torch.tensor([tokens[t]], dtype=torch.int32,
                                                                 device=dev), state)
        out.append(logits[0])
    return out


def full_width_streams(torch, dev, params, cfg):
    """qwen3-1.7b at full width and depth (bf16): 8 prompts x MAX_NEW tokens
    through the captured engine with the fused kernels and through one built
    under the plain-on-card switch.  The greedy streams must be equal; where
    they differ, the plain run's top-2 logit margin at the first differing
    step must be below the largest logit difference of the two, teacher-
    forced on the plain run's tokens to that step (a flip at a near-tie is
    rounding; any other flip is a fault)."""
    import numpy as np

    from repro_torch.kernels._plain import plain_on_card
    from repro_torch.serving.engine import GenerationEngine, _bucket

    rng = np.random.default_rng(SEED + 34)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int64)
               for n in rng.integers(512, 1025, size=MAX_BATCH)]

    def run():
        engine = GenerationEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN, eos_id=-1,
                                  device=dev)
        seqs = [engine.seqs[engine.add_sequence(p, max_new=MAX_NEW)] for p in prompts]
        while engine.seqs:
            engine.step()
        sync(torch, dev)
        return [list(s.tokens) for s in seqs]

    t0 = time.perf_counter()
    got = run()
    with plain_on_card():
        want = run()
    diff = first_difference(got, want)
    log(f"  {cfg.name} full width and depth, {len(prompts)} prompts x {MAX_NEW} tokens: captured "
        f"engine with the fused kernels vs the plain chains: streams "
        f"{'equal' if diff is None else f'differ first at sequence {diff[0]} step {diff[1]}'} "
        f"({time.perf_counter() - t0:.1f}s)")
    if diff is None:
        return
    i, t = diff
    n = len(prompts[i])
    keep = max(MAX_LEN - min(MAX_NEW, MAX_LEN // 2), 1)
    pad_to = min(_bucket(n), keep)
    padded = np.zeros((pad_to,), np.int64)
    padded[pad_to - n:] = prompts[i]
    fused = teacher_forced(torch, dev, cfg, params, padded, want[i], t)[t]
    with plain_on_card():
        plain = teacher_forced(torch, dev, cfg, params, padded, want[i], t)[t]
    top2 = torch.topk(plain.float(), 2).values
    margin = float(top2[0] - top2[1])
    max_diff = float((fused.float() - plain.float()).abs().max())
    log(f"  at that step the plain run's top-2 logit margin is {margin:.4e}, the teacher-forced "
        f"max |logit difference| {max_diff:.4e}: "
        f"{'a near-tie (rounding)' if margin < max_diff else 'NOT a near-tie'}")
    need(margin < max_diff, f"{cfg.name}: the streams differ where the logits are no near-tie")


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


def serve_main_path(torch, dev, index, embedder, arch=ARCH,
                    kernels=("ivf_scan", "decode_attention", "norm", "qk_rope", "glu")):
    """``arch`` at full width and depth (bf16, seeded random weights) served
    through ``Server`` + ``RealBackend``; each kernel of ``kernels`` must
    launch (MLA decodes without ``decode_attention`` and ``qk_rope``).  The
    fused kernels launch only inside the engine's graphs: their counts come
    from the replays."""
    import numpy as np

    import repro_torch.models.layers as layers_mod
    import repro_torch.retrieval.hybrid as hybrid_mod
    from repro_torch import workflows
    from repro_torch.configs import get_config
    from repro_torch.kernels import wrappers
    from repro_torch.launch.serve import build_server
    from repro_torch.models import lm
    from repro_torch.retrieval import HybridRetrievalEngine
    from repro_torch.serving.engine import GenerationEngine

    cfg = get_config(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=dev)
    sync(torch, dev)
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, {cfg.param_count()} params by param_count() "
        f"({2 * cfg.param_count()} bytes in bf16), init {time.perf_counter() - t0:.1f}s")
    # observe the inputs the main path hands each kernel (largest work kept).
    # The engine's decode step is a CUDA graph captured when it is built, so
    # the decode recorder goes in first: it sees the capture's calls, and
    # the tensors it keeps (the last layer's q and lengths, views of the
    # slab) hold what the last replay gave the kernel
    ivf_rec = Recorder(hybrid_mod.ivf_scan, lambda q, gc, slab, valid, k: q.shape[0])
    order = itertools.count()  # decode: keep the last call (longest cache)
    attn_rec = Recorder(layers_mod.decode_attention, lambda q, k, v, lengths: next(order))
    hybrid_mod.ivf_scan, layers_mod.decode_attention = ivf_rec, attn_rec
    try:
        t0 = time.perf_counter()
        engine = GenerationEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN, eos_id=-1,
                                  device=dev)
        sync(torch, dev)
        log(f"  engine: decode step captured as one CUDA graph: {engine._graph is not None} "
            f"(kernel launches a replay {engine._graph_launches}; warm-up + capture "
            f"{time.perf_counter() - t0:.2f}s)")
        need(engine._graph is not None or dev.type != "cuda",
             "the engine did not capture its decode step on the card")
        hybrid = HybridRetrievalEngine(index, cache_capacity=CACHE_CAPACITY,
                                       update_interval=CACHE_UPDATE_INTERVAL,
                                       transit_substages=CACHE_TRANSIT, device=dev)
        rng = np.random.default_rng(SEED + 3)
        prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int64)
                   for n in rng.integers(512, 1025, size=N_REQUESTS)]
        server = build_server(engine, index, embedder, hybrid, prompts, max_new=MAX_NEW,
                              nprobe=NPROBE)
        names = [WORKFLOW_NAMES[i % len(WORKFLOW_NAMES)] for i in range(N_REQUESTS)]
        generated = []
        # host-clock seconds in decode steps (each ends in a sync) and in
        # prefills (each ends in reading its first token), the prefills
        # split by what they ran: a width's first on the card runs the body
        # and captures it, the later ones replay (on the CPU all run eagerly)
        spent = {"steps": 0, "decode": 0.0, "captured": [], "replayed": [], "eager": []}
        orig_step, orig_add = engine.step, engine.add_sequence

        def step():
            spent["steps"] += bool(engine.seqs)
            t = time.perf_counter()
            out = orig_step()
            spent["decode"] += time.perf_counter() - t
            generated.extend(out.values())
            return out

        def add_sequence(*args, **kwargs):
            graphs = len(prefill_graphs(engine))
            t = time.perf_counter()
            sid = orig_add(*args, **kwargs)
            kind = ("eager" if not engine._capture_prefills else
                    "captured" if len(prefill_graphs(engine)) > graphs else "replayed")
            spent[kind].append(time.perf_counter() - t)
            return sid

        engine.step, engine.add_sequence = step, add_sequence
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            reserved0 = torch.cuda.memory_reserved()  # before the first prefill capture
        serving = {n: w for n, w in wrappers().items() if n != "topk_merge"}
        for w in serving.values():
            w.launches = w.plain_calls = 0
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            server.add_request(f"request {i}", workflows.build(name), arrival_us=i * ARRIVAL_GAP_US)
        m = server.run()
        sync(torch, dev)
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in serving.items()}
        plain = {n: w.plain_calls for n, w in serving.items()}
    finally:
        hybrid_mod.ivf_scan, layers_mod.decode_attention = ivf_rec.fn, attn_rec.fn
    st = hybrid.stats()
    log(f"  workflows: {', '.join(names)}")
    log(f"  finished={m.finished}/{N_REQUESTS} wall={wall:.2f}s tokens_generated={len(generated)} "
        f"substages_ret={m.summary().get('substages_ret')} "
        f"substages_with_device_probes={launches['ivf_scan']} cache_hits={st['hits']} "
        f"cache_misses={st['misses']} uploads={st['uploads']}")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else "not measured"
    log(f"  launches: {launches}; plain-version calls {plain}  max_memory_allocated={peak} bytes")
    prefill = {k: sum(spent[k]) for k in ("captured", "replayed", "eager")}
    split = ", ".join(f"{len(spent[k])} {k} {prefill[k]:.3f}s"
                      f"{f' ({1e3 * prefill[k] / len(spent[k]):.2f} ms each)' if spent[k] else ''}"
                      for k in ("captured", "replayed", "eager"))
    log(f"  host clock: {spent['steps']} decode steps (each a replay of the captured graph) "
        f"{spent['decode']:.3f}s ({1e3 * spent['decode'] / max(spent['steps'], 1):.2f} ms a "
        f"step); prefills: {split} (widths {sorted(engine._prefills)}); the rest (retrieval, "
        f"scheduling) {wall - spent['decode'] - sum(prefill.values()):.3f}s of {wall:.3f}s")
    if dev.type == "cuda":
        log(f"  prefill graphs' pool: {pool_bytes(torch, engine._prefill_pool)} bytes; "
            f"memory_reserved {reserved0} bytes before the first prefill capture, "
            f"{torch.cuda.memory_reserved()} after the last")
        need(len(spent["captured"]) <= 2 and not spent["eager"],
             f"{len(spent['captured'])} of the prefills ran eagerly (at most 2, one a width)")
    need(m.finished == N_REQUESTS, f"finished {m.finished} of {N_REQUESTS} requests")
    for name in kernels:
        need(launches[name] > 0, f"the main path launched {name} no time")
    # a CUDA tensor of the serving path never reaches a plain version
    need(dev.type != "cuda" or not any(plain.values()),
         f"the main path took plain versions on the card: {plain}")
    need(len(generated) > 0 and all(0 <= t < cfg.vocab_size for t in generated),
         "generated tokens must lie in the vocabulary")
    return launches, ivf_rec.best, attn_rec.best, hybrid, engine


def check_retrieval_against_host(torch, index, hybrid, embedder, owner=None):
    """Device path (the kernel) against the host path on the real index;
    with ``owner`` (shard mode), the device path of that worker's slots.
    Returns the number of probed clusters that took the device path."""
    import numpy as np

    from repro_torch.retrieval.plan import BatchTopK, PlanBuilder

    queries = np.stack([embedder.embed_query(i, 0) for i in range(16)]).astype(np.float32)
    probes = index.probe_order(queries, NPROBE)
    b = PlanBuilder()
    for i in range(len(queries)):
        b.add(queries[i], probes[i], k=10)
    plan = b.build()
    resident = hybrid.resident_mask(owner)
    n_dev = int(resident[plan.seg_cluster].sum())
    dev_out = hybrid.search_plan(plan, resident=resident, owner=owner)
    host_out = BatchTopK.empty(plan.n_items, plan.k)
    index.scan_segments(plan, np.arange(plan.n_segments), host_out)
    same = dev_out.ids == host_out.ids
    fin = np.isfinite(host_out.dists)
    err = float(np.abs(dev_out.dists[fin] - host_out.dists[fin]).max())
    log(f"  retrieval{'' if owner is None else f' (owner {owner})'}: {plan.n_segments} clusters "
        f"probed, {n_dev} on the device path; ids equal in {int(same.all(-1).sum())}/"
        f"{plan.n_items} items; max |dist diff|={err:.3e}")
    need(np.allclose(dev_out.dists[fin], host_out.dists[fin], rtol=1e-4, atol=1e-5),
         "device-path distances disagree with the host path")
    # an id may differ only where two rows tie within the tolerance
    for r, c in zip(*np.nonzero(~same)):
        need(np.isclose(dev_out.dists[r, c], host_out.dists[r, c], rtol=1e-4, atol=1e-5),
             "device-path ids disagree with the host path")
    return n_dev


def cut_depth(base, n_layers, **overrides):
    """``base`` at full width with only its first ``n_layers`` decoder layers
    (and as many encoder layers), e.g. one segment period."""
    def first(segments, n):
        out = []
        for seg in segments:
            if n > 0:
                out.append(dataclasses.replace(seg, repeat=min(seg.repeat, n)))
                n -= out[-1].repeat
        return tuple(out)

    dec, enc = first(base.segments, n_layers), first(base.encoder_segments, n_layers)
    return dataclasses.replace(base, n_layers=sum(s.repeat for s in dec), segments=dec,
                               encoder_segments=enc, n_encoder_layers=sum(s.repeat for s in enc),
                               **overrides)


def model_extras(torch, cfg, B, rng, dev):
    """Seeded prefix embeddings (VLM) and encoder frames (enc-dec) for ``cfg``."""
    out = {}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model))
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in out.items()}


def decode_vs_prefill(torch, dev, cfg, B, S, seed, what):
    """The logits of one decode step (the decode kernel on attention caches,
    the recurrences on recurrent states) equal prefill's over the same
    S + 1 tokens (plain blocked attention, chunked/scanned recurrences)."""
    import numpy as np

    from repro_torch.models import lm

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = lm.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(B, S + 1)), device=dev)
    kw = model_extras(torch, cfg, B, rng, dev)
    max_len = S + 1 + (cfg.n_prefix_embeds if "prefix_embeds" in kw else 0)
    want, _ = lm.prefill(params, cfg, toks, max_len=max_len, **kw)
    _, state = lm.prefill(params, cfg, toks[:, :S], max_len=max_len, **kw)
    got, _ = lm.decode_step(params, cfg, toks[:, S].to(torch.int32), state)
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **MODEL_F32)) and bool(torch.isfinite(got).all())
    log(f"  {what}: decode vs prefill logits ({B}x{cfg.vocab_size}, S={S}, {cfg.n_layers} layers "
        f"{cfg.dtype}): max_abs_err={err:.3e} (rtol={MODEL_F32['rtol']}, "
        f"atol={MODEL_F32['atol']}) {'ok' if ok else 'FAIL'}")
    need(ok, f"{what}: decode logits disagree with prefill logits")


def check_decode_against_prefill(torch, dev):
    """Full-width qwen3-1.7b cut to 2 layers, f32: the logits of one decode
    step (the decode kernel) equal prefill's over the same tokens (plain
    blocked attention)."""
    from repro_torch.configs import get_config

    decode_vs_prefill(torch, dev, cut_depth(get_config(ARCH), 2, dtype="float32"), 4, 300,
                      SEED + 4, ARCH)


# ---------------------------------------------------------------------------
# the rest of the model zoo
# ---------------------------------------------------------------------------


def no_drop(cfg):
    """MoE capacity that no routing can exceed (C >= tokens): capacity
    depends on the batch shape, so without it one decode token and a
    prefill of S + 1 would drop differently (the JAX reduced() raises the
    factor to 8 for the same reason)."""
    if not cfg.n_experts:
        return {}
    return {"capacity_factor": cfg.n_experts / cfg.moe_top_k}


def serve_moe_path(torch, dev, index, embedder):
    """Phase 10: deepseek-v2-lite-16b (MLA, 64 experts top-6 + 2 shared) at
    full width and depth, served as phase 4 serves qwen3; one decode step
    timed; then decode against prefill on 2 full-width f32 layers."""
    from repro_torch.configs import get_config

    launches, _, _, hybrid, engine = serve_main_path(torch, dev, index, embedder, arch=MOE_ARCH,
                                                     kernels=("ivf_scan", "norm", "glu"))
    if dev.type == "cuda":
        time_decode_step(torch, dev, engine, MOE_ARCH, eager_iters=3)
        time_prefill(torch, dev, engine, MOE_ARCH, PREFILL_WIDTHS[-1:], eager_iters=2)
        log(f"  {MOE_ARCH} peak max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    need(check_retrieval_against_host(torch, index, hybrid, embedder) > 0,
         "phase 10: no probed cluster was resident for the retrieval check")
    del engine, hybrid
    free(torch, dev)
    base = get_config(MOE_ARCH)
    cfg = cut_depth(base, 2, dtype="float32", **no_drop(base))
    decode_vs_prefill(torch, dev, cfg, 4, 300, SEED + 11, f"{MOE_ARCH} (dense layer 0 + 1 MoE layer)")
    return launches


def zoo_checks(torch, dev):
    """Phase 11: each family of ZOO at full width, cut to its first segment
    period (f32), decode against prefill; every decoder-only family (qwen3
    and deepseek too, cut to 2 layers) served by a captured engine (decode
    and prefill graphs) and by its bodies run op by op, to the same greedy
    tokens; then qwen3-1.7b
    at full depth in bf16 with the int8 KV cache against the bf16 cache."""
    from repro_torch.configs import get_config

    for arch, n_layers, lengths in ZOO:
        base = get_config(arch)
        cfg = cut_depth(base, n_layers, dtype="float32", **no_drop(base))
        for S in lengths:
            decode_vs_prefill(torch, dev, cfg, 4 if S <= 512 else 2, S, SEED + 12, arch)
        free(torch, dev)
    for arch, n_layers in ((ARCH, 2), (MOE_ARCH, 2), *((a, n) for a, n, _ in ZOO)):
        base = get_config(arch)
        if not base.is_encoder_decoder:
            captured_vs_eager(torch, dev, cut_depth(base, n_layers, dtype="float32"),
                              SEED + 14, arch)
            free(torch, dev)
    int8_cosine(torch, dev, get_config(ARCH), *INT8_RUN)


def serve_stream(engine, prompts):
    """Admit ``prompts`` (with ``ENGINE_MAX_NEW`` tokens each) whenever a
    slot frees up and step until all are done: slots retire and are
    refilled mid-stream.  Returns (each sequence's tokens, steps)."""
    pending = list(zip(prompts, ENGINE_MAX_NEW))
    seqs, steps = [], 0
    while pending or engine.seqs:
        while pending and engine.can_admit():
            prompt, max_new = pending.pop(0)
            seqs.append(engine.seqs[engine.add_sequence(prompt, max_new=max_new)])
        engine.step()
        steps += 1
    return [list(s.tokens) for s in seqs], steps


def captured_vs_eager(torch, dev, cfg, seed, what):
    """Three engines over one set of weights serve the same prompts through
    2 slots: one replays its captured graphs (the decode step's and one
    prefill graph a padded width, 504 among the widths, replayed out of
    capture order), one (both graphs dropped) runs the same bodies op by
    op, and one captured under the plain-on-card switch replays graphs of
    the plain chains instead of the fused kernels.  The greedy tokens must
    be equal."""
    import contextlib

    import numpy as np

    from repro_torch.kernels._plain import plain_on_card
    from repro_torch.models import lm
    from repro_torch.serving.engine import GenerationEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = lm.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in ENGINE_PROMPTS]
    runs = []
    for kind in ("captured", "eager", "plain chains"):
        with plain_on_card() if kind == "plain chains" else contextlib.nullcontext():
            engine = GenerationEngine(cfg, params, max_batch=2, max_len=ENGINE_MAX_LEN, eos_id=-1,
                                      device=dev)
            need(engine._graph is not None, f"{what}: the engine did not capture its decode step")
            if kind == "eager":
                engine._graph, engine._capture_prefills = None, False  # the bodies, op by op
            runs.append(serve_stream(engine, prompts))
        if kind == "captured":
            widths, fused = prefill_graphs(engine), dict(engine._graph_launches)
        del engine
    (got, steps), (want, _), (plain, _) = runs
    same, same_plain = got == want, got == plain
    log(f"  {what} ({cfg.n_layers} layers {cfg.dtype}): captured engine (prefill graphs at "
        f"widths {widths}; a decode replay launches {fused}) vs its eager bodies, "
        f"{len(prompts)} prompts through 2 slots, {steps} steps: greedy tokens "
        f"{'equal' if same else 'DIFFER'} ({sum(map(len, got))} tokens); vs the captured "
        f"plain chains: {'equal' if same_plain else 'DIFFER'}")
    need(widths == list(ENGINE_WIDTHS), f"{what}: prefill graphs at widths {widths}")
    need(fused.get("norm", 0) > 0, f"{what}: the decode graph launches no fused norm: {fused}")
    need(same, f"{what}: the captured engine's greedy tokens differ from the eager bodies'")
    need(same_plain, f"{what}: the fused kernels' greedy tokens differ from the plain chains'")


def int8_cosine(torch, dev, cfg, B, S, steps):
    """Prefill + ``steps`` teacher-forced decode steps with the int8 KV cache
    and with the model-dtype cache, one set of weights: cosine > 0.999 at
    every step (the JAX package's criterion), argmax agreement printed; the
    card's int8 codes and scales of the bf16 cache's K rows equal the
    CPU's bit for bit."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.models.layers import _quantize_kv

    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    params = lm.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(SEED + 13)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(B, S + steps)), device=dev)
    lf, sf = lm.prefill(params, cfg, toks[:, :S], max_len=S + steps)
    lq, sq = lm.prefill(params, cfg8, toks[:, :S], max_len=S + steps)
    need(sq["segments"][0]["mixer"]["k"].dtype == torch.int8, "the int8 cache is not int8")
    k = sf["segments"][0]["mixer"]["k"][:, :, :S]
    (qc, sc), (qh, sh) = _quantize_kv(k), _quantize_kv(k.cpu())
    same = torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh)
    log(f"  int8 KV codes and scales of {tuple(k.shape)} K rows equal the CPU's: {same}")
    need(same, "int8 KV cache: the card's codes differ from the CPU's")
    cosines, agree = [], 0
    for i in range(S, S + steps):
        lf, sf = lm.decode_step(params, cfg, toks[:, i].to(torch.int32), sf)
        lq, sq = lm.decode_step(params, cfg8, toks[:, i].to(torch.int32), sq)
        cosines.append(float((lf * lq).sum() / (lf.norm() * lq.norm())))
        agree += int((lf.argmax(-1) == lq.argmax(-1)).sum())
    log(f"  {cfg.name} ({cfg.n_layers} layers {cfg.dtype}) int8 KV cache vs {cfg.dtype} cache, "
        f"B={B} S={S}, {steps} decode steps: cosine per step "
        f"{[round(c, 6) for c in cosines]}; argmax agrees {agree}/{B * steps}")
    need(all(c > 0.999 for c in cosines), "int8 KV cache: a step's cosine is <= 0.999")
    del params, sf, sq
    free(torch, dev)


def free(torch, dev):
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def kernel_wrappers():
    from repro_torch.kernels import wrappers

    return wrappers()


def train_full(torch, dev):
    """12a: qwen3-1.7b at full width and depth (bf16, remat), TRAIN_STEPS
    AdamW steps through ``make_train_step`` on one repeated B x S batch, at
    DIVERGING_LR (for the record) and at TRAIN_OPT's lr.  Returns (cfg,
    params, batch, measured numbers)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.training.data import SyntheticTokenStream, to_device
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    cfg = get_config(ARCH)
    need(cfg.remat and cfg.dtype == "bfloat16", "phase 12a: the config is not bf16 with remat")
    shape = ShapeConfig("train_4k", TRAIN_S, TRAIN_B, "train")
    batch = to_device(SyntheticTokenStream(cfg, shape).batch_at(0), dev)

    def train(lr, timed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 20)
        params = lm.init_params(cfg, gen, device=dev)
        opt = init_opt_state(params)
        step = make_train_step(cfg, OptConfig(**dict(TRAIN_OPT, lr=lr)))
        if timed:
            torch.cuda.reset_peak_memory_stats()
        losses, gnorms, dts = [], [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, params, opt, stats = step(params, opt, batch)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
            losses.append(float(loss))
            gnorms.append(float(stats["grad_norm"]))
        need(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
             f"phase 12a: a loss or grad norm at lr {lr} is not finite")
        log(f"  {ARCH} ({cfg.n_layers} layers {cfg.dtype}, remat, {cfg.param_count()} params) "
            f"B={TRAIN_B} S={TRAIN_S}, {TRAIN_STEPS} steps at lr {lr}: losses "
            f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in gnorms]}")
        return params, losses, dts

    params, _, _ = train(DIVERGING_LR, timed=False)
    del params
    free(torch, dev)
    params, losses, dts = train(TRAIN_OPT["lr"], timed=True)
    peak = torch.cuda.max_memory_allocated()
    dt = sum(dts[1:]) / (len(dts) - 1)  # the first step also warms up
    tokens = TRAIN_B * TRAIN_S
    tflops = 6 * cfg.param_count() * tokens / dt / 1e12
    log(f"  step times {[round(x * 1e3, 1) for x in dts]} ms; steps 2-{TRAIN_STEPS} mean "
        f"{dt * 1e3:.1f} ms, {tokens / dt:.0f} tokens/s, model {tflops:.1f} TFLOP/s "
        f"(6 x params x tokens / step time) = {tflops * 1e12 / BF16_FLOPS * 100:.2f}% of "
        f"{BF16_FLOPS / 1e12:.0f}; peak max_memory_allocated {peak} bytes")
    need(losses[-1] < losses[0], "phase 12a: the loss did not decrease")
    return cfg, params, batch, {"step_ms": dt * 1e3, "tokens_per_s": tokens / dt,
                                "tflops": tflops, "peak_bytes": peak}


def compress_grads(torch, dev, cfg, params, batch):
    """12e, first half: (a)'s gradients through ``ErrorFeedback`` (int8
    codes per 256-block) on the card; the residual stays within half a code
    step of each leaf, and the codes of three leaves equal the CPU's bit for
    bit.  Returns two layers' gradients of one leaf for the 2-rank sum."""
    from repro_torch.training.compression import ErrorFeedback, _quantize_blocks
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import leaves_with_paths

    _, grads = value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    send, resid = ErrorFeedback.apply(grads, ErrorFeedback.init(grads))
    torch.cuda.synchronize()
    ef_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for (k, g), (_, s), (_, e) in zip(leaves_with_paths(grads), leaves_with_paths(send),
                                      leaves_with_paths(resid)):
        amax = float(g.abs().max())
        ok = bool(torch.isfinite(s).all()) and float(e.abs().max()) <= amax / 254.0 * (1 + 1e-5)
        need(ok, f"phase 12e: error feedback on {k} is out of bounds")
        worst = max(worst, float(e.abs().max()) / max(amax, 1e-30))
    same = []
    for leaf in (grads["embed"][:8192], grads["segments"][0]["mixer"]["wq"][0],
                 grads["segments"][0]["ffn"]["w2"][-1]):
        q, s, _ = _quantize_blocks(leaf, 256)
        qc, sc, _ = _quantize_blocks(leaf.cpu(), 256)
        same.append(torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc))
    n = sum(g.numel() for _, g in leaves_with_paths(grads))
    log(f"  ErrorFeedback + int8 codes over (a)'s {n} gradient entries on the card: {ef_ms:.1f} ms; "
        f"largest residual {worst:.3e} of its leaf's absmax (bound 1/254 = {1 / 254:.3e}); codes "
        f"and scales equal the CPU's on 3 leaves: {same}")
    need(all(same), "phase 12e: the card's int8 codes differ from the CPU's")
    return [grads["segments"][0]["ffn"]["w1"][r].cpu() for r in range(PSUM_WORLD)]


def _psum_rank(rank, world, port, x, device):
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.training.compression import compressed_psum_leaf

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        got = compressed_psum_leaf(x.to(dev))
        sync(torch, dev)
        dist.barrier()  # no rank tears the group down while a peer still uses it
        # numpy, not a tensor: a CPU tensor would cross by a file descriptor
        # that dies with this process
        return {"sum": got.float().cpu().numpy(), "device": str(got.device), "dtype": str(got.dtype)}
    finally:
        dist.destroy_process_group()


def psum_rank(rank, world, port, x, device, out):
    """One rank of 12e's compressed sum, in a spawned process: reports its
    result (or its traceback) on ``out``."""
    try:
        out.put((rank, _psum_rank(rank, world, port, x, device)))
    except BaseException:
        out.put((rank, traceback.format_exc()))
        raise


def compressed_sum(torch, dev, parts):
    """12e, second half: ``compressed_psum_leaf`` over PSUM_WORLD gloo ranks
    spawned on the one card, rank r holding ``parts[r]``; every rank's sum
    equals the sum of the dequantized codes computed in one process, bit for
    bit, and lies within the codes' error of the exact sum.  gloo moves the
    CUDA tensors through the host."""
    from repro_torch.training.compression import _quantize_blocks

    t0 = time.perf_counter()
    results = spawn_ranks(torch, psum_rank, [(x, str(dev)) for x in parts])
    qs = [_quantize_blocks(x.to(dev), 256) for x in parts]
    deq = torch.stack([q for q, _, _ in qs]).float() * torch.stack([s for _, s, _ in qs])[..., None]
    pad = qs[0][2]
    want = deq.sum(0).reshape(-1)
    want = (want[:-pad] if pad else want).reshape(parts[0].shape).to(parts[0].dtype).float().cpu()
    exact = sum(x.float() for x in parts)
    err = float((want - exact).abs().max())
    tol = sum(float(x.float().abs().max()) for x in parts) / 127.0
    same = all(torch.equal(torch.from_numpy(r["sum"]), want) for r in results.values())
    log(f"  compressed_psum_leaf over {PSUM_WORLD} gloo ranks on the card ({results[0]['device']} "
        f"{results[0]['dtype']} in and out, through the host) on a {tuple(parts[0].shape)} leaf: "
        f"{'equal' if same else 'DIFFERENT'} to the one-process dequantized sum on every rank; "
        f"max error to the exact sum {err:.3e} (bound {tol:.3e}); {time.perf_counter() - t0:.1f}s")
    need(same and err <= tol, "phase 12e: the compressed sum is wrong")


def train_card_vs_cpu(torch, dev):
    """12b: one train step of qwen3-1.7b at full width cut to 2 layers, f32,
    from the same converted parameters on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training.data import SyntheticTokenStream, to_device
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves_with_paths, tree_map

    cfg = cut_depth(get_config(ARCH), 2, dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(SEED + 21)
    cpu_params = lm.init_params(cfg, gen, device="cpu")
    card_params = params_from_numpy(tree_map(lambda t: t.numpy(), cpu_params), cfg, device=dev)
    batch = SyntheticTokenStream(cfg, ShapeConfig("step", CPU_STEP_S, CPU_STEP_B, "train")).batch_at(0)
    step = make_train_step(cfg, OptConfig(**TRAIN_OPT))
    out = {}
    for name, params, d in (("cpu", cpu_params, torch.device("cpu")), ("card", card_params, dev)):
        t0 = time.perf_counter()
        loss, p, o, stats = step(params, init_opt_state(params), to_device(batch, d))
        out[name] = (float(loss), p, o, float(stats["lr"]), time.perf_counter() - t0)
    (lc, pc, oc, lr, sc), (lg, pg, og, _, sg) = out["cpu"], out["card"]
    loss_ok = abs(lg - lc) <= STEP_LOSS_RTOL * abs(lc)
    worst_mu, worst_p, worst_frac = 0.0, 0.0, 0.0
    for (k, a), (_, b) in zip(leaves_with_paths(og["mu"]), leaves_with_paths(oc["mu"])):
        worst_mu = max(worst_mu, float((a.cpu() - b).norm() / b.norm().clamp(min=1e-30)))
    for (k, a), (_, b) in zip(leaves_with_paths(pg), leaves_with_paths(pc)):
        diff = (a.cpu() - b).abs()
        worst_p = max(worst_p, float(diff.max()))
        worst_frac = max(worst_frac, float((diff > STEP_PARAM_ATOL).float().mean()))
    ok = (loss_ok and worst_mu <= STEP_MU_RTOL and worst_p <= 2.2 * lr
          and worst_frac <= STEP_PARAM_FRAC)
    log(f"  {ARCH} cut to 2 layers, f32, TF32 off, B={CPU_STEP_B} S={CPU_STEP_S}, one step: loss "
        f"card {lg!r} cpu {lc!r}; first moments max rel err {worst_mu:.3e} (<= {STEP_MU_RTOL}); "
        f"parameters max abs err {worst_p:.3e} (<= 2.2 x lr = {2.2 * lr:.1e}), largest share of "
        f"a leaf off by > {STEP_PARAM_ATOL}: {worst_frac:.2e} (<= {STEP_PARAM_FRAC}); step {sc:.1f}s "
        f"on the CPU, {sg:.2f}s on the card {'ok' if ok else 'FAIL'}")
    need(ok, "phase 12b: the card's train step disagrees with the CPU's")


def zoo_train(torch, dev):
    """12c: each other family at full width cut to its first segment period:
    ``train_loss`` and its gradient; the loss equals the cross-entropy of the
    port's own forward logits and every gradient entry is finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.training.data import SyntheticTokenStream, to_device
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import leaves_with_paths

    for arch, n_layers, lengths in ZOO + ((MOE_ARCH, 2, (ZOO_TRAIN_S,)),):
        base = get_config(arch)
        dtype = "bfloat16" if arch in ZOO_TRAIN_BF16 else "float32"
        cfg = cut_depth(base, n_layers, dtype=dtype, **no_drop(base))
        S = max(lengths[-1], ZOO_TRAIN_S)  # recurrentgemma: past its 2048-row window
        B = ZOO_TRAIN_B if S <= 512 else 1
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 23)
        params = lm.init_params(cfg, gen, device=dev)
        batch = to_device(SyntheticTokenStream(cfg, ShapeConfig("zoo", S, B, "train")).batch_at(0),
                          dev)
        batch["labels"][:, -1] = -1  # a masked label in each row
        t0 = time.perf_counter()
        loss, grads = value_and_grad(cfg, params, batch)
        finite = all(bool(torch.isfinite(g).all()) for _, g in leaves_with_paths(grads))
        dt = time.perf_counter() - t0
        with torch.no_grad():
            logits = lm.forward(params, cfg, batch["tokens"],
                                **{k: v for k, v in batch.items() if k.endswith("_embeds")})
            ce = float(torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), batch["labels"].long().reshape(-1),
                ignore_index=-1))
        tol = LOSS_BF16 if dtype == "bfloat16" else LOSS_F32
        ok = finite and abs(float(loss) - ce) <= tol["rtol"] * abs(ce)
        log(f"  {arch} ({cfg.n_layers} layers {dtype}) B={B} S={S}: train loss {float(loss):.6f}, "
            f"forward cross-entropy {ce:.6f} (rtol {tol['rtol']}); gradients finite: {finite}; "
            f"loss + backward {dt:.2f}s {'ok' if ok else 'FAIL'}")
        need(ok, f"phase 12c: {arch}'s train loss or gradients are wrong")
        del params, grads, logits, batch
        free(torch, dev)


def checkpoint_resume(torch, dev, tmp):
    """12d: qwen3-1.7b at full width cut to 2 layers (bf16): 3 steps
    uninterrupted, against 2 steps, a save, a restore onto the card through
    ``ElasticRunner`` (the restore's tree built on the meta device) and the
    third step: the same parameters, moments and losses, bit for bit."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.elastic import ElasticConfig, ElasticRunner
    from repro_torch.models import lm
    from repro_torch.training.data import SyntheticTokenStream, to_device
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves_with_paths

    cfg = cut_depth(get_config(ARCH), 2)
    ds = SyntheticTokenStream(cfg, ShapeConfig("ckpt", 512, 2, "train"))
    step = make_train_step(cfg, OptConfig(**TRAIN_OPT))

    def init_fn(d):
        gen = None
        if torch.device(d).type != "meta":
            gen = torch.Generator(device=d)
            gen.manual_seed(SEED + 22)
        params = lm.init_params(cfg, gen, device=d)
        return {"params": params, "opt": init_opt_state(params)}

    def run(state, steps):
        p, o, losses = state["params"], state["opt"], []
        for s in steps:
            loss, p, o, _ = step(p, o, to_device(ds.batch_at(s), dev))
            losses.append(float(loss))
        return {"params": p, "opt": o}, losses

    ref, ref_losses = run(init_fn(dev), range(3))
    shutil.rmtree(tmp, ignore_errors=True)
    runner = ElasticRunner(ElasticConfig(ckpt_dir=str(tmp), save_every=2), lambda: dev,
                           lambda d: step)
    _, _, state, start = runner.resume_or_init(init_fn)
    need(start == 0, "phase 12d: a fresh directory resumed")
    state, losses = run(state, range(2))
    t0 = time.perf_counter()
    path = runner.maybe_save(2, state)
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    del state
    free(torch, dev)
    t0 = time.perf_counter()
    _, _, state, start = runner.resume_or_init(init_fn)
    restore_s = time.perf_counter() - t0
    need(start == 2 and state["params"]["embed"].device.type == dev.type,
         "phase 12d: the runner did not resume onto the card from step 2")
    state, more = run(state, [2])
    la, lb = leaves_with_paths(state), leaves_with_paths(ref)
    same = [k for (k, a), (_, b) in zip(la, lb) if not torch.equal(a, b)] == []
    worst = max(float((a.float() - b.float()).abs().max()) for (_, a), (_, b) in zip(la, lb))
    log(f"  {ARCH} cut to 2 layers ({cfg.dtype}), B=2 S=512: losses {losses + more} resumed, "
        f"{ref_losses} uninterrupted; saved {size} bytes in {save_s:.1f}s, restored in "
        f"{restore_s:.1f}s; state after step 3 {'bit-identical' if same else 'DIFFERS'} "
        f"(max abs diff {worst:.3e}; checked bit for bit, without "
        f"torch.use_deterministic_algorithms)")
    need(same and losses + more == ref_losses, "phase 12d: the resumed run differs from the "
         "uninterrupted one")
    shutil.rmtree(tmp, ignore_errors=True)


def run_train_launcher(tmp):
    """12e: the train launcher on the card as a user runs it, then again
    after its last checkpoint is lost: the rerun resumes from step 3 and
    ends at the first run's loss."""
    import os
    import re
    import shutil

    ckpt = tmp / "launch"
    shutil.rmtree(ckpt, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_LAUNCHER_ARGS,
           "--ckpt-dir", str(ckpt)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    lasts = []
    for run in range(2):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=LAUNCHER_TIMEOUT_S)
        log(f"  {' '.join(cmd[1:])}: exit {r.returncode} in {time.perf_counter() - t0:.1f}s; "
            + " | ".join(r.stdout.splitlines()))
        need(r.returncode == 0, f"the train launcher failed:\n{r.stderr[-3000:]}")
        m = re.search(r"last loss (\S+)$", r.stdout.strip())
        need(m is not None, "the train launcher printed no last loss")
        lasts.append(float(m.group(1)))
        if run == 0:
            need(sorted(p.name for p in ckpt.iterdir()) == ["step_00000003", "step_00000006"],
                 "the train launcher did not save steps 3 and 6")
            shutil.rmtree(ckpt / "step_00000006")
        else:
            need("resumed from step 3" in r.stdout, "the train launcher did not resume from step 3")
    need(abs(lasts[1] - lasts[0]) <= 1e-5 * abs(lasts[0]),
         f"the resumed launcher ended at loss {lasts[1]}, the first run at {lasts[0]}")


def train_phase(torch, dev, out_dir):
    """Phase 12; returns each kernel's launches over it (none expected) and
    12a's numbers."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    cfg, params, batch, numbers = train_full(torch, dev)
    parts = compress_grads(torch, dev, cfg, params, batch)
    del params, batch
    free(torch, dev)
    log(f"  12a + 12e's codes took {time.perf_counter() - t0:.1f}s")
    compressed_sum(torch, dev, parts)
    train_card_vs_cpu(torch, dev)
    free(torch, dev)
    zoo_train(torch, dev)
    checkpoint_resume(torch, dev, out_dir / "ckpt")
    free(torch, dev)
    run_train_launcher(out_dir)
    launches = {name: w.launches for name, w in wrappers.items()}
    need(all(n == 0 for n in launches.values()),
         f"phase 12 launched a kernel the training path should not reach: {launches}")
    return launches, numbers


# ---------------------------------------------------------------------------
# the sharded path
# ---------------------------------------------------------------------------


def pack_slab(torch, dev, index, tile_len):
    """The whole index as a (C, tile_len, d) f32 slab on ``dev`` (rows of
    cluster c at tile c, zero-padded) and its (C,) int32 valid counts."""
    import numpy as np

    sizes = index.cluster_sizes()
    C, d = index.n_clusters, index.dim
    slab = torch.zeros((C, tile_len, d), dtype=torch.float32, device=dev)
    cl = np.repeat(np.arange(C), sizes)
    dest = cl * tile_len + (np.arange(index.flat.shape[0]) - index.offsets[cl])
    slab.view(C * tile_len, d).index_copy_(0, torch.from_numpy(dest).to(dev),
                                           torch.from_numpy(index.flat).to(dev))
    return slab, torch.from_numpy(sizes.astype(np.int32)).to(dev)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sharded_rank(rank, world, port, q, shared, k):
    import datetime

    import torch
    import torch.distributed as dist

    import repro_torch.retrieval.distributed as dist_mod
    from repro_torch.kernels.topk_merge import topk_merge

    # the only references to the tensors shared by CUDA IPC: dropping them at
    # the end releases the parent's slab
    slab, valid = shared
    shared.clear()
    dev = slab.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        search = dist_mod.make_sharded_search(k)
        qd = q.to(dev)
        search(qd, slab, valid)  # warm-up: BLAS handles, the kernel's library
        rec = Recorder(dist_mod.topk_merge, lambda *a: 0)  # keeps the first call
        dist_mod.topk_merge = rec
        sync(torch, dev)
        dist.barrier()
        topk_merge.launches = 0
        t0 = time.perf_counter()
        dists, rows = search(qd, slab, valid)
        sync(torch, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = topk_merge.launches
        dist_mod.topk_merge = rec.fn
        dist.barrier()  # no rank tears the group down while a peer still uses it
        # gloo takes the CUDA tensors and passes them through the host
        gather = f"gloo all-gather of {dev.type} tensors"
        return {"d": dists.cpu().numpy(), "r": rows.cpu().numpy(), "launches": launches,
                "wall_ms": wall_ms, "gather": gather, "tiles": int(slab.shape[0]),
                "merge_in": [t.cpu().numpy() for t in rec.best]}
    finally:
        del slab, valid
        sync(torch, dev)
        dist.destroy_process_group()


def sharded_rank(rank, world, port, q, shared, k, out):
    """One rank of phase 7, in a spawned process: reports its result (or its
    traceback) on ``out``.  ``shared`` is [slab range, valid range]."""
    try:
        out.put((rank, _sharded_rank(rank, world, port, q, shared, k)))
    except BaseException:
        out.put((rank, traceback.format_exc()))
        raise


def run_ranks(torch, q, slab, valid, k, world):
    """Spawn ``world`` ranks, rank r on the r-th contiguous tile range of
    ``slab``; returns their results by rank."""
    Cl = slab.shape[0] // world
    return spawn_ranks(torch, sharded_rank,
                       [(q, [slab[r * Cl:(r + 1) * Cl], valid[r * Cl:(r + 1) * Cl]], k)
                        for r in range(world)])


def spawn_ranks(torch, target, rank_args):
    """Spawn one process a rank, running ``target(rank, world, port,
    *rank_args[rank], out)`` (gloo's rendezvous at localhost:port); returns
    their results by rank.  Fails if a rank fails, exits without a result or
    does not report within ``RANK_TIMEOUT_S``."""
    import torch.multiprocessing as tmp

    world = len(rank_args)
    ctx = tmp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, daemon=True, args=(r, world, port, *rank_args[r], out))
             for r in range(world)]
    results = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            try:
                rank, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results and p.exitcode is not None]
                need(not dead, f"ranks {dead} exited without a result (exit codes "
                               f"{[procs[r].exitcode for r in dead]})")
                need(time.monotonic() < deadline,
                     f"ranks {sorted(set(range(world)) - set(results))} did not report "
                     f"within {RANK_TIMEOUT_S}s")
                continue
            need(not isinstance(res, str), f"rank {rank} failed:\n{res}")
            results[rank] = res
        for p in procs:
            p.join(timeout=60)
        need(all(p.exitcode == 0 for p in procs),
             f"rank exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return results


def sharded_search(torch, dev, index, tile_len, embedder):
    """Phase 7: make_sharded_search over WORLD ranks on the card, held
    against reference_search over the whole slab."""
    import numpy as np

    from repro_torch.kernels.ivf_scan.ref import topk_agreement
    from repro_torch.kernels.topk_merge import ops as merge_ops
    from repro_torch.kernels.topk_merge import ref as merge_ref
    from repro_torch.retrieval.distributed import reference_search

    t0 = time.perf_counter()
    slab, valid = pack_slab(torch, dev, index, tile_len)
    sync(torch, dev)
    log(f"  slab {tuple(slab.shape)} f32 ({slab.numel() * 4} bytes) on {dev.type}, "
        f"packed in {time.perf_counter() - t0:.1f}s")
    q = torch.from_numpy(np.stack([embedder.embed_query(i, 0) for i in range(SHARD_QUERIES)])
                         .astype(np.float32))
    t0 = time.perf_counter()
    results = run_ranks(torch, q, slab, valid, SHARD_K, WORLD)
    log(f"  {WORLD} ranks ({results[0]['gather']}) in {time.perf_counter() - t0:.1f}s; per rank: "
        + ", ".join(f"rank {r} {res['tiles']} tiles, search {res['wall_ms']:.1f} ms, "
                    f"topk_merge launches {res['launches']}" for r, res in sorted(results.items())))
    d0, r0 = results[0]["d"], results[0]["r"]
    for r, res in results.items():
        need(np.array_equal(res["d"], d0) and np.array_equal(res["r"], r0),
             f"rank {r}'s result differs from rank 0's: outputs must be replicated")
        need(res["launches"] > 0, f"rank {r} launched topk_merge no time")
    dref, rref = reference_search(q.to(dev), slab, valid, SHARD_K + 1)
    err, ties, bad = topk_agreement(dref[:, :SHARD_K].cpu(), rref[:, :SHARD_K].cpu(),
                                    dref[:, SHARD_K].cpu(), torch.from_numpy(d0),
                                    torch.from_numpy(r0), **F32)
    log(f"  sharded search vs reference_search over the whole slab (Q={SHARD_QUERIES}, "
        f"k={SHARD_K}): max_abs_err={err:.3e} (rtol={F32['rtol']}, atol={F32['atol']}) "
        f"boundary_ties={ties} mismatched_rows={bad}")
    need(bad == 0, f"sharded search: {bad} query rows disagree with reference_search")
    del slab, valid, dref, rref
    if dev.type == "cuda":
        torch.cuda.ipc_collect()  # the ranks have released their views
        torch.cuda.empty_cache()
    check_against_brute_force(torch, dev, index, tile_len, q, d0, r0)
    # the kernel against its plain version on each rank's own merge inputs
    merge_in = {r: [torch.from_numpy(a).to(dev) for a in res["merge_in"]]
                for r, res in results.items()}
    merr = max(check_merge(torch, merge_ops, merge_ref, args, f"rank {r}'s merge input")
               for r, args in merge_in.items())
    rd, ri, cd, ci = merge_in[0]
    log(f"  topk_merge on the ranks' inputs (run {tuple(rd.shape)}, cand {tuple(cd.shape)}, "
        f"ids {str(ri.dtype)[6:]}): equal to the plain version bit for bit")
    return sum(res["launches"] for res in results.values()), merr, merge_in[0]


def check_against_brute_force(torch, dev, index, tile_len, q, dists, rows):
    """A witness independent of the port's scan: exact f64 distances from
    every query to every row of the index, in row order, stably sorted;
    the sharded search's global slab rows are mapped back to index rows."""
    import numpy as np

    from repro_torch.kernels.ivf_scan.ref import topk_agreement

    k = dists.shape[1]
    flat = torch.from_numpy(index.flat).to(dev, torch.float64)
    qd = q.to(dev, torch.float64)
    d2 = (qd * qd).sum(-1, keepdim=True) - 2.0 * qd @ flat.T + (flat * flat).sum(-1)[None, :]
    del flat
    bd, bi = torch.sort(d2, dim=1, stable=True)
    bd, bi = bd[:, :k + 1].cpu(), bi[:, :k + 1].cpu()
    del d2
    tile, col = rows // tile_len, rows % tile_len
    got_rows = torch.from_numpy(index.offsets[tile] + col)
    err, ties, bad = topk_agreement(bd[:, :k], bi[:, :k], bd[:, k], torch.from_numpy(dists),
                                    got_rows, **F32)
    log(f"  sharded search vs exact f64 brute force over all {index.flat.shape[0]} rows: "
        f"max_abs_err={err:.3e} (rtol={F32['rtol']}, atol={F32['atol']}) boundary_ties={ties} "
        f"mismatched_rows={bad}")
    need(bad == 0, f"sharded search: {bad} query rows disagree with the brute force")


def serve_sharded(torch, dev, index, embedder, engine):
    """Phase 8: shard-mode serving over RealBackend with one crashed worker."""
    import numpy as np

    from repro_torch import workflows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ivf_scan import ivf_scan
    from repro_torch.kernels.topk_merge import topk_merge
    from repro_torch.launch.serve import build_server
    from repro_torch.retrieval import HybridRetrievalEngine
    from repro_torch.retrieval.distributed import scatter_gather_search
    from repro_torch.retrieval.plan import PlanBuilder
    from repro_torch.serving.faults import FaultPlan, WorkerCrash

    hybrid = HybridRetrievalEngine(index, cache_capacity=CACHE_CAPACITY,
                                   update_interval=CACHE_UPDATE_INTERVAL,
                                   transit_substages=CACHE_TRANSIT, device=dev)
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, engine.cfg.vocab_size, size=int(n)).astype(np.int64)
               for n in rng.integers(512, 1025, size=N_REQUESTS)]
    plan = FaultPlan(crashes=(WorkerCrash(CRASH_WORKER, CRASH_AT_US),))
    server = build_server(engine, index, embedder, hybrid, prompts, max_new=MAX_NEW,
                          nprobe=NPROBE, ret_workers=SHARD_WORKERS, index_sharding=True,
                          fault_plan=plan)
    names = [WORKFLOW_NAMES[i % len(WORKFLOW_NAMES)] for i in range(N_REQUESTS)]
    kernels = (ivf_scan, decode_attention, topk_merge)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        server.add_request(f"request {i}", workflows.build(name), arrival_us=i * ARRIVAL_GAP_US)
    m = server.run()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    sched = server.sched
    rep = server.shard_report()
    st = hybrid.stats()
    log(f"  plan: {plan.describe()}")
    log(f"  finished={m.finished} shed={m.shed} degraded={m.degraded_completions} of {N_REQUESTS} "
        f"wall={wall:.2f}s worker_deaths={m.worker_deaths} failovers={m.failovers} "
        f"shard_scatters={rep['shard_scatters']} shard_parts={rep['shard_parts']} "
        f"shard_merges={rep['shard_merges']} per_owner_resident={rep['per_owner_resident']} "
        f"cache_hits={st['hits']} cache_misses={st['misses']} launches={launches}")
    need(not sched.active and not sched.pending and m.finished + m.shed == N_REQUESTS,
         f"shard mode: {m.finished} finished + {m.shed} shed of {N_REQUESTS}; "
         f"{len(sched.active)} active, {len(sched.pending)} pending")
    need(m.worker_deaths == 1, f"shard mode: {m.worker_deaths} worker deaths, expected 1")
    need(rep["shard_scatters"] > 0 and rep["shard_merges"] > 0, "shard mode: no scatter-gather")
    need(sum(v > 0 for v in rep["per_owner_resident"].values()) >= 2,
         "shard mode: fewer than 2 owners hold resident clusters")
    need(launches["ivf_scan"] > 0, "shard mode launched ivf_scan no time")
    sm = sched.shard_map
    survivors = {w for w in range(sm.n_shards) if sched.lifecycle.alive(w)}
    # each surviving owner's device path (its own slots) against the host path
    n_dev = sum(check_retrieval_against_host(torch, index, hybrid, embedder, owner=w)
                for w in sorted(survivors))
    need(n_dev > 0, "shard mode: no probed cluster was resident on a surviving owner")
    # surviving-shard parity: scatter-gather over the survivors against one
    # plan over the same filtered probe lists, on the real index
    q = np.stack([embedder.embed_query(1000 + i, 0) for i in range(4)]).astype(np.float32)
    D, I = scatter_gather_search(index, q, 16, 5, sm, shards=survivors)
    probes = index.probe_order(q, 16)
    b = PlanBuilder()
    for r in range(q.shape[0]):
        b.add(q[r], [int(c) for c in probes[r] if int(sm.owner[c]) in survivors], k=5)
    ref_plan = b.build()
    res = ref_plan.finalize(index.search_plan(ref_plan))
    same = np.array_equal(D, res.dists[:, :5]) and np.array_equal(I, res.ids[:, :5])
    log(f"  scatter_gather_search over surviving shards {sorted(survivors)} vs one plan: "
        f"{'equal bit for bit' if same else 'DIFFERENT'}")
    need(same, "scatter_gather_search over the surviving shards differs from its oracle")
    return launches


# ---------------------------------------------------------------------------
# the wall-clock serving stack
# ---------------------------------------------------------------------------


class RepeatEmbedder:
    """A request that repeats an earlier request's text embeds as that
    request does (``same_as``: request id -> the earlier one), so the
    cross-request layer can fuse it or answer it from the global cache."""

    def __init__(self, base, same_as):
        self.base, self.same_as = base, dict(same_as)
        self.dim = base.dim

    def embed_query(self, request_id, round_idx):
        return self.base.embed_query(self.same_as.get(request_id, request_id), round_idx)

    def embed_partial(self, request_id, round_idx, ratio):
        return self.base.embed_partial(self.same_as.get(request_id, request_id), round_idx, ratio)


def wallclock_stream():
    """The open-loop stream of phase 9 and its repeats: WC_DRAWN arrivals of
    the heterogeneous mix; the multi-round ones first, then the earliest,
    are each sent again (same text and workflow) at their own instant, just
    after them.  The single producer submits in list order, so a request's
    id is its place in the list."""
    from repro_torch.serving.workload import MIXES

    drawn = MIXES["heterogeneous"].sample(WC_DRAWN, rate_per_s=WC_RATE, seed=WC_SEED)
    again = set(sorted(range(WC_DRAWN), key=lambda i: (drawn[i].workflow not in
                                                      ("multistep", "irg"), i))[:WC_REPEATS])
    stream, same_as = [], {}
    for i, item in enumerate(drawn):
        first = len(stream)
        stream.append(dataclasses.replace(item, text=f"request {i}"))
        if i in again:
            same_as[len(stream)] = first
            stream.append(stream[first])
    return stream, same_as


def wallclock_stack(dev, index, embedder, params, cfg, prompts, cost_model=None):
    """A fresh stack for phase 9: a new engine over ``params``, a new
    512-slot hybrid engine with replication 2, and ``build_server`` with the
    cross-request layer, tracing and telemetry on."""
    from repro_torch.launch.serve import build_server
    from repro_torch.retrieval import HybridRetrievalEngine
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.workload import MIXES

    engine = GenerationEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN, eos_id=-1,
                              device=dev)
    hybrid = HybridRetrievalEngine(index, cache_capacity=CACHE_CAPACITY,
                                   update_interval=CACHE_UPDATE_INTERVAL,
                                   transit_substages=CACHE_TRANSIT, replication=2, device=dev)
    return build_server(engine, index, embedder, hybrid, prompts, max_new=MAX_NEW,
                        nprobe=NPROBE, cost_model=cost_model,
                        workload=MIXES["heterogeneous"].profile(), **WC_SERVER)


def serve_wallclock_stack(torch, dev, index, embedder, params, cfg):
    """Phase 9: the stream of ``wallclock_stream`` through
    ``Server.serve_wallclock`` with a ``DurationTape`` recording; the
    checks of the run, then its replay on a fresh stack, bit for bit.
    Returns (kernel launches of the run, the ivf_scan input of a fused
    plan's device scan)."""
    import collections

    import numpy as np

    import repro_torch.retrieval.hybrid as hybrid_mod
    from repro_torch.kernels import wrappers
    from repro_torch.kernels.ivf_scan import ivf_scan
    from repro_torch.serving import ingress

    free(torch, dev)  # phase 8's stack holds a slab and reference cycles
    stream, same_as = wallclock_stream()
    emb = RepeatEmbedder(embedder, same_as)
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int64)
               for n in rng.integers(512, 1025, size=len(stream))]
    classes = collections.Counter(it.workflow for it in stream)
    log(f"  stream: {len(stream)} requests, {dict(sorted(classes.items()))}; requests "
        f"{sorted(same_as)} repeat {[same_as[r] for r in sorted(same_as)]}")
    need(classes["compress"] + classes["pipeline"] > 0, "the stream has no compress or pipeline request")
    server = wallclock_stack(dev, index, emb, params, cfg, prompts)
    hybrid = server.backend.hybrid
    tape = ingress.DurationTape()
    ingress.tape_backend(server.backend, tape, mode="record")
    # the device scans of fused plans (group_fanout > 1): count them and
    # keep the ivf_scan input of the last one
    order = itertools.count()
    ivf_rec = Recorder(hybrid_mod.ivf_scan, lambda *a: next(order))
    fused = {"plans": 0, "device": 0, "input": None}
    plain_search = hybrid.search_plan

    def search_plan(plan, **kw):
        fan = int(plan.group_fanout.max(initial=1))
        n0 = ivf_scan.launches
        out = plain_search(plan, **kw)
        if fan > 1:
            fused["plans"] += 1
            if ivf_scan.launches > n0:
                fused["device"] += 1
                fused["input"] = ivf_rec.best
        return out

    hybrid.search_plan = search_plan
    hybrid_mod.ivf_scan = ivf_rec
    try:
        torch.cuda.reset_peak_memory_stats()
        serving = {n: w for n, w in wrappers().items() if n != "topk_merge"}
        for w in serving.values():
            w.launches = w.plain_calls = 0
        t0 = time.perf_counter()
        m, trace = server.serve_wallclock(stream, speedup=1.0, max_wall_s=WC_MAX_WALL_S)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in serving.items()}
        plain = {n: w.plain_calls for n, w in serving.items()}
    finally:
        hybrid_mod.ivf_scan = ivf_rec.fn
        hybrid.search_plan = plain_search
    peak = torch.cuda.max_memory_allocated()
    rep = server.crossreq_report()
    st = hybrid.stats()
    n_fused = rep["dedup"]["exact_subscribed"] + rep["dedup"]["near_subscribed"]
    gc_hits = rep["global_cache"]["exact_hits"] + rep["global_cache"]["near_answers"]
    done = collections.Counter(r.graph.name for r in server.sched.done)
    log(f"  served {m.finished}/{len(stream)} in {wall:.2f}s wall, by class "
        f"{dict(sorted(done.items()))}; trace rows {len(trace.rows)}; taped charges "
        f"{len(tape.rows)}")
    log(f"  fused queries {n_fused} (dedup {rep['dedup']}); global-cache hits {gc_hits} "
        f"(global cache {rep['global_cache']}); global_cache_answers "
        f"{m.global_cache_answers}; replica loads {st['replica_loads']}, replicated clusters "
        f"{st['replicated_clusters']}, cache hits {st['hits']} misses {st['misses']}")
    log(f"  fused plans {fused['plans']}, on the device path {fused['device']}; launches "
        f"{launches}; max_memory_allocated={peak} bytes")
    need(m.finished == len(stream) and not server.sched.active and not server.sched.pending,
         f"finished {m.finished} of {len(stream)} requests")
    for name, n in launches.items():
        need(n > 0, f"phase 9 launched {name} no time")
    need(not any(plain.values()), f"phase 9 took plain versions on the card: {plain}")
    need(n_fused > 0, "the cross-request layer fused no query")
    need(st["replica_loads"] > 0, "no replica was loaded")
    need(fused["input"] is not None, "no fused plan went through the device path")
    # every worker's device view (its slots, replicas included) against the host
    n_dev = sum(check_retrieval_against_host(torch, index, hybrid, embedder, owner=w)
                for w in range(WC_SERVER["ret_workers"]))
    need(n_dev > 0, "no probed cluster was resident on either worker")
    # the observability layer
    tr = json.loads(json.dumps(server.export_trace()))
    spans = [e for e in tr["traceEvents"] if e.get("ph") == "X"]
    gen_spans = sum(e["tid"] == 1 for e in spans)
    ret_spans = sum(e["tid"] >= 10 for e in spans)
    att = server.attribution_report(check=True)
    prom = server.metrics_snapshot()["prometheus"]
    log(f"  trace: {len(tr['traceEvents'])} events, {len(spans)} spans ({gen_spans} generation, "
        f"{ret_spans} retrieval); attribution over {att['finished']} requests, max residual "
        f"{att['max_rel_residual']:.3e}, bottleneck {att['bottleneck']}; prometheus "
        f"{len(prom.splitlines())} lines")
    need(gen_spans > 0 and ret_spans > 0, "the trace lacks generation or retrieval spans")
    need(prom.strip() != "", "the Prometheus exposition is empty")
    # the replay: a fresh stack, the same trace and charges, the same bits
    recorded = server.fingerprints()
    cost_model = server.backend.cluster_cost_model
    t0 = time.perf_counter()
    replica = wallclock_stack(dev, index, emb, params, cfg, prompts, cost_model=cost_model)
    ingress.tape_backend(replica.backend, tape, mode="replay")
    rm = ingress.replay_trace(replica, trace)
    sync(torch, dev)
    same = replica.fingerprints() == recorded
    log(f"  replay on a fresh stack: {rm.finished} finished in {time.perf_counter() - t0:.2f}s "
        f"wall, {tape.remaining()} charges unconsumed; fingerprints "
        f"{'bit-identical' if same else 'DIFFER'}")
    need(same and tape.remaining() == 0, "the replay's fingerprints differ from the recorded run's")
    return launches, fused["input"]


def run_launcher(tmp):
    """The launcher on the card as a user runs it; it must exit 0 and say
    that its replay check passed."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCHER_ARGS,
           "--trace-out", str(tmp / "trace.json"), "--metrics-out", str(tmp / "metrics.json")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=LAUNCHER_TIMEOUT_S)
    lines = [ln for ln in r.stdout.splitlines() if not ln.startswith("  ")]
    log(f"  {' '.join(cmd[1:])}: exit {r.returncode} in {time.perf_counter() - t0:.1f}s; "
        + " | ".join(lines))
    need(r.returncode == 0, f"the launcher failed:\n{r.stderr[-3000:]}")
    need(any(ln.startswith("replay-check ok") for ln in lines), "the launcher's replay check did not pass")
    need((tmp / "trace.json").stat().st_size > 0 and (tmp / "metrics.json").stat().st_size > 0,
         "the launcher wrote no trace or metrics")


def sharded_like_input(torch, gen, Q, k, lists, dev):
    """Rows shaped like make_sharded_search's merge: one ascending run of k
    and ``lists`` ascending candidate lists of k, int64 ids."""
    rd = torch.rand((Q, k), generator=gen, device=dev).sort(dim=1).values
    cd = torch.rand((Q, lists, k), generator=gen, device=dev).sort(dim=2).values.reshape(Q, -1)
    ri = torch.randint(0, 2**31 - 1, (Q, k), generator=gen, device=dev)
    ci = torch.randint(0, 2**31 - 1, (Q, lists * k), generator=gen, device=dev)
    return rd, ri, cd, ci


def time_merge(torch, dev, merge_ops, merge_ref, args, what, chunks=()):
    """topk_merge, its plain version, torch.topk over the candidates
    concatenated beforehand (timed only: it promises no order among ties),
    one torch.sum over as many bytes, and the kernel at each forced chunk
    of ``chunks`` (checked bit for bit against the plain version first)."""
    rd, ri, cd, ci = args
    (Q, k), m, idb = rd.shape, cd.shape[1], ri.element_size()
    # every distance read once, the k selected ids read once, k pairs written
    n_bytes = Q * (k + m) * 4 + Q * k * idb + Q * k * (4 + idb)
    b_ms, b_by = bound(n_bytes, 0, F32_FLOPS)  # no arithmetic: bytes bound it
    ms = time_ms(torch, dev, lambda: merge_ops.topk_merge(rd, ri, cd, ci), iters=50)
    plain = time_ms(torch, dev, lambda: merge_ref.topk_merge_ref(rd, ri, cd, ci), iters=50)
    cat = torch.cat([rd, cd], dim=1)
    lib = time_ms(torch, dev, lambda: torch.topk(cat, k, dim=1, largest=False), iters=50)
    floor = read_floor_ms(torch, dev, n_bytes)
    var = []
    for chunk in chunks:
        check_merge(torch, merge_ops, merge_ref, args, f"{what} chunk={chunk}", chunk=chunk)
        c_ms = time_ms(torch, dev, lambda: merge_ops.topk_merge(rd, ri, cd, ci, _chunk=chunk),
                       iters=50)
        var.append(f", chunk={chunk} {c_ms:.4f} ms")
    log(f"  topk_merge {what} Q={Q} k={k} m={m} ids {str(ri.dtype)[6:]}: {n_bytes} bytes; "
        f"kernel {ms:.4f} ms (default chunk){''.join(var)}, plain {plain:.4f} ms, "
        f"torch.topk {lib:.4f} ms, bound {b_ms:.6f} ms ({b_by}); one torch.sum over as many "
        f"bytes {floor:.4f} ms")
    return {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def fixed_ivf_input(torch, index, tile_len, dev):
    """ivf_scan at one fixed shape made from SEED, so that runs compare like
    with like (the main path's G changes from run to run): 17 groups on 17
    distinct real clusters, each group one real query (near its cluster's
    centroid, as IVF probes are) and QB - 1 zero rows, k 5."""
    import numpy as np

    rng = np.random.default_rng(SEED + 8)
    G, QB = 17, 8
    cids = rng.choice(index.n_clusters, G, replace=False)
    slab = np.zeros((G, tile_len, index.dim), np.float32)
    valid = np.zeros((G,), np.int32)
    for s, cid in enumerate(cids):
        lo, hi = int(index.offsets[cid]), int(index.offsets[cid + 1])
        slab[s, : hi - lo] = index.flat[lo:hi]
        valid[s] = hi - lo
    q = np.zeros((G, QB, index.dim), np.float32)
    real = index.centroids[cids] + 0.05 * rng.standard_normal((G, index.dim))
    q[:, 0] = real / np.linalg.norm(real, axis=-1, keepdims=True)
    gc = np.arange(G, dtype=np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (q, gc, slab, valid)) + (5,)


def ivf_sizing(torch, q, gc, slab, valid, k):
    """(bytes, f32 FLOPs) ivf_scan must move and do on this input: the valid
    rows of each distinct probed cluster read once, the queries, the cluster
    ids and counts, the output; 2*d FLOPs per (real query, valid row)."""
    G, QB, d = q.shape
    rows = valid[gc.long()].long()
    uniq = torch.unique(gc.long())
    n_bytes = (int(valid[uniq].long().sum()) * d * slab.element_size() + q.numel() * q.element_size()
               + 4 * (G + slab.shape[0]) + G * QB * k * 8)
    n_ops = 2 * d * int((rows * (q.abs().sum(-1) > 0).sum(-1)).sum())
    return n_bytes, n_ops


def read_floor_ms(torch, dev, n_bytes):
    """One PyTorch kernel that reads ``n_bytes`` once (a sum), timed as the
    kernels are: what this timing gives for streaming those bytes."""
    buf = torch.ones(max(1, n_bytes // 4), dtype=torch.float32, device=dev)
    return time_ms(torch, dev, lambda: buf.sum(), iters=50)


# ---------------------------------------------------------------------------
# the mesh (phase 13)
# ---------------------------------------------------------------------------


class _SpecMesh:
    """The production mesh's axes, for reckoning shard sizes by hand."""
    shape = {"data": 32, "model": 8}
    axis_names = ("data", "model")


def hand_argument_bytes(arch, shape_name):
    """Local shard bytes of a cell's step arguments, reckoned from the rules'
    specs and the stand-ins' shapes (no DTensor): each leaf's bytes over the
    product of the mesh axes its spec names."""
    import math

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs
    from repro_torch.training.tree import leaves_with_paths

    mesh, cfg, shape = _SpecMesh(), get_config(arch), SHAPES_BY_NAME[shape_name]
    ispec = specs.input_specs(cfg, shape)

    def local(leaf, spec):
        n = leaf.numel() * leaf.element_size()
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                n //= mesh.shape[a]
        return n

    total = sum(local(leaf, sh.param_spec(cfg, mesh, path, leaf))
                for path, leaf in leaves_with_paths(ispec["params"]))
    if shape.kind == "train":
        specs_of = dict(sh.param_specs(cfg, mesh, ispec["params"]))
        for part in ("mu", "nu"):
            total += sum(local(leaf, specs_of[path])
                         for path, leaf in leaves_with_paths(ispec["opt_state"][part]))
        total += local(ispec["opt_state"]["step"], ())
        bspec = sh.batch_spec(cfg, mesh, shape)
        total += sum(local(leaf, bspec[k]) for k, leaf in ispec["batch"].items())
    else:
        total += sum(local(leaf, sh.decode_state_spec(cfg, mesh, shape.global_batch, path, leaf))
                     for path, leaf in leaves_with_paths(ispec["state"]))
        total += local(ispec["tokens"], sh.tokens_spec(mesh, shape.global_batch))
    return total


def dryrun_cells(torch, out_dir):
    """13a: ``launch.dryrun`` on the production mesh (256 ranks, tp layout)
    for DRYRUN_CELLS, each a process of its own (the fake group is
    process-wide), all at once; memory, FLOPs, collectives and roofline
    printed and checked."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        path = out_dir / f"{arch}.{shape}.single.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--mesh", "single", "--out", str(path), "--quiet"]
        procs[(arch, shape)] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), path)
    from repro_torch.configs import SHAPES_BY_NAME as SHAPES

    recs = {}
    try:
        for cell, (p, path) in procs.items():
            log_text, _ = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            need(p.returncode == 0 and path.exists(),
                 f"phase 13a: the dry-run of {cell} exited {p.returncode}:\n{log_text[-3000:]}")
            rec = json.loads(path.read_text())[0]
            need("error" not in rec, f"phase 13a: {cell}: {rec.get('error')}\n"
                                     f"{rec.get('traceback', '')[-3000:]}")
            recs[cell] = rec
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for (arch, shape), rec in recs.items():
        m, c, rf, mf = rec["memory"], rec["scan_level_costs"], rec["roofline"], rec["model"]
        hand = hand_argument_bytes(arch, shape)
        tokens = (SHAPES[shape].global_batch * SHAPES[shape].seq_len
                  if rec["kind"] == "train" else SHAPES[shape].global_batch)
        k = 6.0 if rec["kind"] == "train" else 2.0
        ndd = k * mf["active_params"] * tokens
        log(f"  {arch} {shape} on {rec['mesh_shape']} ({rec['chips']} ranks, traced in "
            f"{rec['compile_s']:.1f}s): per device arguments {m['argument_bytes'] / 1e9:.3f} GB "
            f"(by hand {hand / 1e9:.3f} GB), peak {m['peak_bytes_est'] / 1e9:.3f} GB "
            f"(fits 80 GB: {rf['fits_hbm']}); {c['flops_per_device']:.4e} FLOP traced, model "
            f"{mf['model_flops_per_device']:.4e} (useful/traced {rf['useful_flops_ratio']:.3f})")
        log(f"    collectives: counts {c['collective_counts']}, bytes by op "
            f"{c['collective_bytes_by_op']}, by mesh dim {c['collective_bytes_by_axis']}")
        log(f"    roofline (H100 data sheet): compute {rf['t_compute_s'] * 1e3:.3f} ms, memory "
            f"{rf['t_memory_s'] * 1e3:.3f} ms (op-bytes bound "
            f"{rf['t_memory_op_bytes_upper_s'] * 1e3:.1f} ms), collective {rf['t_collective_s'] * 1e3:.3f} ms "
            f"{ {a: round(t * 1e3, 3) for a, t in rf['t_collective_by_axis_s'].items()} }; "
            f"dominant {rf['dominant']}")
        need(m["argument_bytes"] == hand,
             f"phase 13a: {arch} {shape} argument bytes {m['argument_bytes']} != {hand} by hand")
        need(mf["model_flops_global"] == ndd,
             f"phase 13a: {arch} {shape} model FLOPs {mf['model_flops_global']} != {k:.0f}·N·D")
        need(c["flops_per_device"] > 0 and c["collective_bytes"] > 0,
             f"phase 13a: {arch} {shape} traced no FLOPs or no collectives")
    return recs


def _mesh_rank(rank, world, port, device, backend, shape):
    import datetime
    import faulthandler

    faulthandler.enable()  # a crash in a collective prints its stack

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.models import layers, lm
    from repro_torch.training.data import SyntheticTokenStream, to_device
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves_with_paths, tree_map

    dev = torch.device(device)
    if dev.type == "cuda":
        # NCCL takes one card a rank (it refuses two ranks on one device);
        # gloo ranks share the first card, as phase 7's do
        idx = rank % torch.cuda.device_count() if backend == "nccl" else (dev.index or 0)
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        mesh = init_device_mesh(dev.type, shape, mesh_dim_names=("data", "model"))
        if rank == 0:
            log(f"  rank 0: mesh {mesh}")
        cfg = cut_depth(get_config(ARCH), MESH_LAYERS, dtype="float32", remat=False)
        res = {"coord": mesh.get_coordinate()}
        params = lm.init_params(cfg, seed=SEED, device=dev)
        shape = ShapeConfig("mesh", MESH_TRAIN_S, MESH_TRAIN_B, "train")
        batch = to_device(SyntheticTokenStream(cfg, shape).batch_at(0), dev)
        step = make_train_step(cfg, OptConfig(**MESH_OPT))

        # one step on the (2, 2) mesh ...
        placed = sh.param_shardings(cfg, mesh, params)
        opt = sh.opt_state_shardings(mesh, init_opt_state(params), placed)
        t0 = time.perf_counter()
        with use_mesh(mesh):
            placed_batch = sh.to_named(mesh, sh.batch_spec(cfg, mesh, shape), batch)
            loss, placed, opt, _ = step(placed, opt, placed_batch)
            loss = float(loss.full_tensor())
        sync(torch, dev)
        res["step_s"] = time.perf_counter() - t0
        if rank == 0:
            log(f"  rank 0: sharded step done in {res['step_s']:.2f}s")
        whole = {k: v.full_tensor() for k, v in leaves_with_paths(placed)}
        del placed, opt
        # ... and unsharded, from the same parameters (each rank computes it)
        ref = tree_map(lambda t: t.clone(), params)
        ref_loss, ref, _, _ = step(ref, init_opt_state(ref), batch)
        res["loss"], res["ref_loss"] = loss, float(ref_loss)
        n = off = 0
        worst = 0.0
        for k, want in leaves_with_paths(ref):
            diff = (whole[k] - want).abs()
            worst = max(worst, float(diff.max()))
            off += int((diff > MESH_PARAM_ATOL).sum())
            n += diff.numel()
        res["param_max_diff"], res["param_frac_off"] = worst, off / n
        del whole, ref

        # sharded prefill + greedy decode over the sequence-sharded cache
        rng = np.random.default_rng(SEED + 13)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (MESH_DECODE_B, MESH_PROMPT)),
                                 dtype=torch.int32, device=dev)
        seen = []
        plain_call = layers.decode_attention

        def recording(q, k, v, lengths, **kw):
            if kw.get("return_lse"):
                seen[:] = [q, k, v, lengths]
            return plain_call(q, k, v, lengths, **kw)

        placed = sh.param_shardings(cfg, mesh, params)
        attn_ops.decode_attention.launches = 0
        layers.decode_attention = recording
        try:
            t0 = time.perf_counter()
            with use_mesh(mesh):
                toks = lm.greedy(placed, cfg, prompt, max_len=MESH_MAX_LEN, steps=MESH_STEPS)
                _, state = lm.prefill(placed, cfg, prompt, max_len=MESH_MAX_LEN)
            sync(torch, dev)
            res["decode_s"] = time.perf_counter() - t0
        finally:
            layers.decode_attention = plain_call
        res["launches"] = attn_ops.decode_attention.launches
        k_cache = state["segments"][0]["mixer"]["k"]
        res["cache"] = (f"{tuple(k_cache.shape)} placements {list(map(str, k_cache.placements))}, "
                        f"local {tuple(k_cache.to_local().shape)}")
        # the kernel's (output, lse) on this rank's last block, held to plain
        q, k, v, lens = seen
        out, lse = attn_ops.decode_attention(q, k, v, lens, return_lse=True)
        want, want_lse = attn_ref.decode_attention_ref(q, k, v, lens, return_lse=True)
        fin = torch.isfinite(want_lse)
        res["lse_lengths"] = lens.tolist()
        res["lse_err"] = float((lse[fin] - want_lse[fin]).abs().max()) if fin.any() else 0.0
        res["lse_ok"] = (bool(torch.allclose(out, want, **F32))
                         and bool(torch.allclose(lse[fin], want_lse[fin], **ATTN_LSE))
                         and bool(torch.equal(torch.isneginf(lse), ~fin)))
        res["out_err"] = float((out - want).abs().max())
        res["tokens"] = toks.cpu().numpy()
        res["ref_tokens"] = lm.greedy(params, cfg, prompt, max_len=MESH_MAX_LEN,
                                      steps=MESH_STEPS).cpu().numpy()
        sync(torch, dev)
        dist.barrier()  # no rank tears the group down while a peer still uses it
        return res
    finally:
        dist.destroy_process_group()


def mesh_rank(rank, world, port, device, backend, shape, out):
    """One rank of 13b, in a spawned process: reports its result (or its
    traceback) on ``out``."""
    try:
        out.put((rank, _mesh_rank(rank, world, port, device, backend, shape)))
    except BaseException:
        out.put((rank, traceback.format_exc()))
        raise


def mesh_on_card(torch, dev, backend=MESH_BACKEND, shape=MESH_SHAPE):
    """13b: a (data, model) mesh of ``shape`` ranks (spawned processes) on
    the one card: the train step on the mesh against the unsharded one, and
    greedy decode over the cache laid out by the decode-state rules (the
    kernel on each rank's block, with its log-sum-exp) against the
    unsharded tokens; every rank must launch decode_attention and its
    log-sum-exp output must agree with the plain version."""
    import math

    import numpy as np

    t0 = time.perf_counter()
    log(f"  mesh {shape} of {backend} ranks on the card")
    results = spawn_ranks(torch, mesh_rank, [(str(dev), backend, shape)] * math.prod(shape))
    for r, res in sorted(results.items()):
        log(f"  rank {r} at {res['coord']}: loss {res['loss']:.6f} "
            f"(unsharded {res['ref_loss']:.6f}), "
            f"params max |diff| {res['param_max_diff']:.3e}, {res['param_frac_off'] * 100:.4f}% "
            f"over {MESH_PARAM_ATOL}; step {res['step_s']:.2f}s; decode_attention launches "
            f"{res['launches']}, lse on lengths {res['lse_lengths']}: max_abs_err "
            f"{res['lse_err']:.3e} (out {res['out_err']:.3e}) {'ok' if res['lse_ok'] else 'FAIL'}; "
            f"tokens {'equal' if np.array_equal(res['tokens'], res['ref_tokens']) else 'DIFFER'}; "
            f"prefill+{MESH_STEPS} steps {res['decode_s']:.2f}s")
    log(f"  cache {results[0]['cache']}; {time.perf_counter() - t0:.1f}s")
    lr = MESH_OPT["lr"]
    for r, res in results.items():
        need(abs(res["loss"] - res["ref_loss"]) <= MESH_LOSS_RTOL * abs(res["ref_loss"]),
             f"phase 13b: rank {r}'s sharded loss differs from the unsharded one")
        need(res["param_max_diff"] <= 2 * lr and res["param_frac_off"] <= MESH_PARAM_FRAC,
             f"phase 13b: rank {r}'s updated parameters differ from the unsharded step")
        need(np.array_equal(res["tokens"], res["ref_tokens"]),
             f"phase 13b: rank {r}'s greedy tokens differ from the unsharded decode")
        need(res["launches"] > 0, f"phase 13b: rank {r} never launched decode_attention")
        need(res["lse_ok"], f"phase 13b: rank {r}'s log-sum-exp output disagrees with plain")
    return {r: res["launches"] for r, res in results.items()}, max(
        max(res["lse_err"], res["out_err"]) for res in results.values())


def launcher_through_host_mesh(torch, dev, tmp):
    """13c: ``launch.train`` on the card through its host mesh ((1, 1) on one
    card) against the one-device loop it ran before it had a mesh (the same
    step, parameters and stream, no DTensor): the losses must be equal."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.training.data import SyntheticTokenStream, to_device
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    steps = int(MESH_LAUNCHER_ARGS[MESH_LAUNCHER_ARGS.index("--steps") + 1])
    got = train.main([*MESH_LAUNCHER_ARGS, "--device", "cuda", "--ckpt-dir", str(tmp)])["losses"]
    cfg = get_config("qwen3-1.7b").reduced()
    base = SHAPES_BY_NAME["train_4k"]
    shape = ShapeConfig(base.name, 128, 8, base.kind)
    params = lm.init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptConfig(total_steps=steps))
    ds = SyntheticTokenStream(cfg, shape)
    want = {}
    for i in range(steps):
        loss, params, opt, _ = step(params, opt, to_device(ds.batch_at(i), dev))
        want[i] = float(loss)
    log(f"  launch.train {' '.join(MESH_LAUNCHER_ARGS)} through the host mesh: losses {got}; "
        f"one-device loop {want}: {'equal' if got == want else 'DIFFER'}")
    need(got == want, "phase 13c: the launcher's losses through the host mesh differ")


def mesh_phase(torch, dev, out_dir):
    """Phase 13; returns decode_attention's launches by rank and the largest
    kernel-vs-plain error of its log-sum-exp checks."""
    t0 = time.perf_counter()
    log("  13a: the dry-run on the production mesh (data=32, model=8)")
    dryrun_cells(torch, out_dir / "dryrun")
    log(f"  13a took {time.perf_counter() - t0:.1f}s")
    t1 = time.perf_counter()
    log(f"  13b: a {MESH_SHAPE} {MESH_BACKEND} mesh on the card")
    launches, err = mesh_on_card(torch, dev)
    log(f"  13b took {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    log("  13c: the train launcher through the host mesh")
    launcher_through_host_mesh(torch, dev, out_dir / "launcher")
    log(f"  13c took {time.perf_counter() - t1:.1f}s")
    return launches, err


def step_bytes(engine):
    """The bytes one decode step of ``engine`` must move at its current
    state: every parameter read once (the tied embedding once, as the
    head), each cache's rows up to each slot's ``cache_len + 1`` read once
    (the row written counted among them), every other state leaf read and
    written once."""
    from repro_torch.training.tree import leaves

    params = sum(t.numel() * t.element_size() for t in leaves(engine.params))
    lens = (engine.state["cache_len"].long() + 1).cpu()
    state = 0
    for seg in engine.state["segments"]:
        for group in seg.values():
            for name, t in (group.items() if isinstance(group, dict) else [("", group)]):
                if name in ("k", "v", "k_scale", "v_scale", "ckv", "kpe"):
                    rows = t.shape[2]  # (L, B, rows, ...)
                    row_bytes = t[0, 0, 0].numel() * t.element_size()
                    state += t.shape[0] * int(lens.clamp(max=rows).sum()) * row_bytes
                else:
                    state += 2 * t.numel() * t.element_size()
    return params + state


def profile_once(torch, fn, n_top=3):
    """(device ops, device-busy ms, wall ms, the ``n_top`` costliest kernel
    names with their summed ms and counts) of one ``fn()`` under
    ``torch.profiler`` (CPU and CUDA activities), after one call outside it;
    busy time is the union of the ops' device intervals, wall time the host
    clock around the call and its synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    return (len(spans), busy / 1e3, wall, [(n[:60], round(us / 1e3, 4), c) for n, (us, c) in top],
            {n: c for n, (_, c) in by_name.items()})


# ATen's bf16 elementwise add (tensor + tensor, or with a scalar): in
# qwen3's decode step only a residual add, all of which the norm now takes
BF16_ADD = "add<c10::BFloat16>"


def log_profile(torch, what, fn, n_top=3):
    """Print ``profile_once`` of ``fn``: device ops, busy and wall time, the
    costliest kernel names (ms summed over the call, launches); with
    ``n_top`` > 3 one line a name.  Returns the launches by kernel name
    (None where the profiler traced no device op)."""
    n_ops, busy, wall, top, counts = profile_once(torch, fn, n_top)
    if n_ops == 0:
        log(f"  profiler, one {what}: no device activity traced (not measured); "
            f"wall {wall:.3f} ms")
        return None
    head = (f"  profiler, one {what}: {n_ops} device ops, device busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall ({100 * busy / wall:.1f}%)")
    if n_top <= 3:
        log(f"{head}; costliest (name, ms, launches) {top}")
        return
    log(f"{head}; device time by kernel name, top {n_top} (ms, launches):")
    for name, ms, count in top:
        log(f"    {ms:9.4f} ms {count:6d}x  {name}")
    return counts


def launches_named(counts, part) -> int:
    """Launches of the kernels whose name holds ``part``."""
    return sum(c for name, c in counts.items() if part in name)


def time_decode_step(torch, dev, engine, what, eager_iters=5):
    """The engine's decode step at its current state, eager (its step body
    op by op) and replayed (the captured graph), with CUDA events, beside
    the byte floor; then one of each under the profiler.  Returns
    (eager ms, replay ms)."""
    need(engine._graph is not None, f"{what}: the engine holds no captured graph")
    n_bytes = step_bytes(engine)
    floor_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    eager = time_ms(torch, dev, engine._decode, iters=eager_iters, warmup=1)
    replay = time_ms(torch, dev, engine._graph.replay, iters=20)
    log(f"  {what} decode step B={engine.max_batch} ({engine.cfg.n_layers} layers, Σ cache_len "
        f"{int(engine.state['cache_len'].sum())}): eager {eager:.3f} ms, replayed graph "
        f"{replay:.3f} ms ({eager / replay:.1f}x); byte floor {floor_ms:.3f} ms ({n_bytes} bytes "
        f"at {HBM_BYTES_PER_S / 1e12} TB/s; the replay at {100 * floor_ms / replay:.1f}% of it)")
    for name, fn in (("eager", engine._decode), ("replay", engine._graph.replay)):
        counts = log_profile(torch, f"{name} step", fn, n_top=15 if name == "replay" else 3)
    if counts is not None:
        log(f"  {what} replayed step: {launches_named(counts, 'norm_kernel')} norm launches, "
            f"{launches_named(counts, BF16_ADD)} bf16 elementwise adds")
    return eager, replay, counts


def prefill_graphs(engine) -> list:
    """The padded widths whose admission graph the engine has captured."""
    return sorted(w for w, b in engine._prefills.items() if b.graph is not None)


def pool_bytes(torch, pool) -> int:
    """Bytes of the device memory segments of the CUDA-graph memory pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def prefill_floor(cfg, engine, width):
    """(bytes, bf16 FLOP, f32 FLOP, floor ms, bound by) of one admission at
    ``width``.  Bytes: every parameter read once and one slot's state
    written once.  bf16: 2 x width x the parameters a token touches (MoE:
    its top-k and shared experts; the embedding is a lookup), plus the
    head for the last token.  f32: the blocked attention's score and value
    products over the query-chunk x key blocks it computes (masked entries
    included: 4 x heads x head dim x queries x keys a layer; MLA at its
    padded 192-wide heads).  The floor is the larger of the bytes at the
    HBM rate and the two FLOP counts at their peaks, added."""
    from repro_torch.training.tree import leaves

    n_bytes = sum(t.numel() * t.element_size() for t in leaves(engine.params))
    n_bytes += sum(t[:, :1].numel() * t.element_size() for t in leaves(engine.state["segments"]))
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    bf16 = 2 * width * (cfg.active_param_count() - embed) + 2 * cfg.d_model * cfg.vocab_size
    f32 = 0
    for seg in cfg.segments:
        if seg.mixer not in ("attn", "local_attn", "mla"):
            continue
        dh = cfg.nope_head_dim + cfg.rope_head_dim if seg.mixer == "mla" else cfg.d_head
        window = cfg.local_window if seg.mixer == "local_attn" else 0
        qc, pairs = min(cfg.attn_q_chunk, width), 0
        for q0 in range(0, width, qc):
            q1 = min(q0 + qc, width)
            pairs += (q1 - q0) * (q1 - (max(0, q0 - window + 1) if window else 0))
        f32 += seg.repeat * 4 * cfg.n_heads * dh * pairs
    ops_ms = (bf16 / BF16_FLOPS + f32 / F32_FLOPS) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return n_bytes, bf16, f32, max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def time_prefill(torch, dev, engine, what, widths, eager_iters=3):
    """One admission of a seeded prompt at each padded width into a free
    slot of the engine's slab: the body op by op (eager) and the width's
    graph replayed, with CUDA events, beside the width's floor; one of each
    under the profiler; then the prefill graphs' pool."""
    import numpy as np

    rng = np.random.default_rng(SEED + 20)
    slot = engine.free_slots[-1]
    for width in widths:
        t0 = time.perf_counter()
        first = engine._admit(rng.integers(1, engine.cfg.vocab_size, size=width), slot)
        buf = engine._prefills[width]
        need(buf.graph is not None and 0 <= first < engine.cfg.vocab_size,
             f"{what}: no prefill graph at width {width}")
        admit_s = time.perf_counter() - t0
        body = functools.partial(engine._prefill, buf)
        eager = time_ms(torch, dev, body, iters=eager_iters, warmup=1)
        replay = time_ms(torch, dev, buf.graph.replay, iters=10)
        n_bytes, bf16, f32, floor_ms, by = prefill_floor(engine.cfg, engine, width)
        log(f"  {what} prefill + insert at width {width} ({engine.cfg.n_layers} layers, slot "
            f"{slot} of {engine.max_batch}, max_len {engine.max_len}; first admission "
            f"{admit_s:.3f}s): eager {eager:.3f} ms, replayed graph {replay:.3f} ms "
            f"({eager / replay:.1f}x); floor {floor_ms:.3f} ms ({by}: {bf16} bf16 FLOP at "
            f"{BF16_FLOPS / 1e12:.0f} TFLOP/s + {f32} f32 FLOP at {F32_FLOPS / 1e12:.0f} "
            f"TFLOP/s, {n_bytes} bytes at {HBM_BYTES_PER_S / 1e12} TB/s; the replay at "
            f"{100 * floor_ms / replay:.1f}% of it)")
        for name, fn in (("eager", body), ("replay", buf.graph.replay)):
            counts = log_profile(torch, f"{name} prefill at width {width}", fn,
                                 n_top=20 if name == "replay" else 3)
        if counts is not None:
            log(f"  {what} replayed admission at {width}: {launches_named(counts, 'norm_kernel')} "
                f"norm launches, {launches_named(counts, BF16_ADD)} bf16 elementwise adds")
    log(f"  {what} prefill graphs' pool: {pool_bytes(torch, engine._prefill_pool)} bytes for "
        f"widths {prefill_graphs(engine)}; memory_reserved {torch.cuda.memory_reserved()} bytes")


def time_kernels(torch, dev, ivf_in, attn_in, engine, merge_in, fixed_ivf):
    """Phase 6: each kernel, its plain version and (decode, merge) one
    PyTorch call, timed on the inputs the main path and the sharded search
    gave them, beside the bound of that work; ivf_scan also at a fixed
    shape, topk_merge also at pod scale."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    from repro_torch.kernels.ivf_scan import ref as ivf_ref
    from repro_torch.kernels.topk_merge import ops as merge_ops
    from repro_torch.kernels.topk_merge import ref as merge_ref

    def time_ivf(q, gc, slab, valid, k, what):
        G, QB, d = q.shape
        real_q = int((q.abs().sum(-1) > 0).sum())
        n_bytes, n_ops = ivf_sizing(torch, q, gc, slab, valid, k)
        b_ms, b_by = bound(n_bytes, n_ops, F32_FLOPS)
        ms = time_ms(torch, dev, lambda: ivf_ops.ivf_scan(q, gc, slab, valid, k), iters=50)
        plain = time_ms(torch, dev, lambda: ivf_ref.ivf_scan_ref(q, gc, slab, valid, k), iters=5)
        floor = read_floor_ms(torch, dev, n_bytes)
        log(f"  ivf_scan {what} G={G} QB={QB} (real queries {real_q}) d={d} L={slab.shape[1]} "
            f"k={k}: {n_bytes} bytes, {n_ops} f32 FLOP; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), library none; one torch.sum over as many bytes "
            f"{floor:.4f} ms")
        return {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    tiny = torch.zeros(1, device=dev)
    log(f"  timing floor: a one-element kernel {time_ms(torch, dev, lambda: tiny.add_(1), iters=50):.4f} ms")
    ivf = time_ivf(*ivf_in, "main-path input")
    time_ivf(*fixed_ivf, "fixed shape (17 real clusters, 1 real query a group)")
    aq, ak, av, alen = attn_in

    B, H, dh = aq.shape
    KV = ak.shape[2]
    lens = alen.long()
    esz = ak.element_size()
    attn_bytes = int(lens.sum()) * KV * dh * esz * 2 + 2 * aq.numel() * esz + 4 * B
    attn_ops_n = 4 * int(lens.sum()) * H * dh
    attn_bound, attn_by = bound(attn_bytes, attn_ops_n, BF16_FLOPS)
    attn_ms = time_ms(torch, dev, lambda: attn_ops.decode_attention(aq, ak, av, alen), iters=50)
    attn_plain = time_ms(torch, dev, lambda: attn_ref.decode_attention_ref(aq, ak, av, alen))
    # the variant that also writes each head's log-sum-exp (the sharded decode's)
    attn_lse_ms = time_ms(torch, dev, lambda: attn_ops.decode_attention(aq, ak, av, alen,
                                                                         return_lse=True), iters=50)
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
        f"{attn_ms:.4f} ms (with the log-sum-exp output {attn_lse_ms:.4f} ms), plain "
        f"{attn_plain:.4f} ms, SDPA {attn_lib:.4f} ms "
        f"(max |SDPA - plain| {lib_err:.3e}), bound {attn_bound:.4f} ms ({attn_by}); one "
        f"torch.sum over as many bytes {read_floor_ms(torch, dev, attn_bytes):.4f} ms")
    # the decode step those launches sit in: all layers at the same state
    eager_ms, replay_ms, counts = time_decode_step(torch, dev, engine, ARCH)
    n_layers = engine.cfg.n_layers
    log(f"  its {n_layers} decode_attention launches: {n_layers * attn_ms:.3f} ms, "
        f"{100 * n_layers * attn_ms / eager_ms:.1f}% of the eager step, "
        f"{100 * n_layers * attn_ms / replay_ms:.1f}% of the replay")
    time_prefill(torch, dev, engine, ARCH, PREFILL_WIDTHS)
    # the same step and admissions through the plain chains (the model body
    # before the fused kernels), on one card in one run: the before of the
    # fused kernels' after
    from repro_torch.kernels._plain import plain_on_card

    twin = plain_chain_twin(torch, dev, engine)
    with plain_on_card():
        twin_counts = time_decode_step(torch, dev, twin, f"{ARCH} plain chains")[2]
        time_prefill(torch, dev, twin, f"{ARCH} plain chains", PREFILL_WIDTHS)
    # every residual add of qwen3's step is a norm's delta: none runs alone.
    # The count is read from the profiler by ATen's kernel name, so the
    # plain chains' step must show its residual adds under that name too
    need(counts is not None and twin_counts is not None,
         "the profiler traced no device op of a replayed decode step: its adds are not counted")
    need(launches_named(twin_counts, BF16_ADD) > 0,
         f"no {BF16_ADD!r} kernel in the plain chains' step: the name no longer finds the adds")
    need(launches_named(counts, BF16_ADD) == 0,
         f"{ARCH}'s replayed decode step runs a residual add outside the norm")
    del twin
    free(torch, dev)
    fused = time_fused(torch, dev)
    full_width_streams(torch, dev, engine.params, engine.cfg)
    free(torch, dev)

    # beside the wrapper's chunk, the network's other choices: at the
    # sharded input (16 rows: one 64-key chunk holds a row) K'-key chunks
    # of 32; at pod scale (K'-key chunks of 32) 64 keys, and 128 (the row)
    merge = time_merge(torch, dev, merge_ops, merge_ref, merge_in, "sharded-search input", (32,))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    time_merge(torch, dev, merge_ops, merge_ref,
               merge_inputs(torch, gen, POD_Q, POD_K, POD_M, torch.int64, dev), "pod scale",
               (64, 128))
    time_merge(torch, dev, merge_ops, merge_ref,
               sharded_like_input(torch, gen, POD_Q, POD_K, POD_M // POD_K, dev),
               "pod scale, sorted run + 3 sorted lists", (64, 128))
    return {
        "topk_merge": merge,
        "ivf_scan": ivf,
        "decode_attention": {"ms": attn_ms, "plain_ms": attn_plain, "bound_ms": attn_bound,
                             "bound_by": attn_by, "library_ms": attn_lib},
        **fused,
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
    from repro_torch.kernels.topk_merge import ops as merge_ops
    from repro_torch.kernels.topk_merge import ref as merge_ref
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
    merge_err = merge_cases(torch, merge_ops, merge_ref, dev)
    log(f"  ivf_scan boundary ties counted: {ivf_ties}")
    fused_err = {"norm": norm_cases(torch, dev), "qk_rope": qk_rope_cases(torch, dev),
                 "glu": glu_cases(torch, dev)}

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
    need(check_retrieval_against_host(torch, index, hybrid, embedder) > 0,
         "no probed cluster was resident for the retrieval check")
    check_decode_against_prefill(torch, dev)

    # 7. the sharded search ----------------------------------------------------
    log(f"[7] sharded search: {WORLD} gloo ranks on one card, the whole index")
    t0 = time.perf_counter()
    merge_launches, e, merge_in = sharded_search(torch, dev, index, tile_len, embedder)
    merge_err = max(merge_err, e)
    log(f"  phase 7 took {time.perf_counter() - t0:.1f}s")

    # 8. shard-mode serving -----------------------------------------------------
    log(f"[8] shard-mode serving: {SHARD_WORKERS} shard owners, worker {CRASH_WORKER} crashes")
    t0 = time.perf_counter()
    serve_sharded(torch, dev, index, embedder, engine)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f}s")

    # 9. the wall-clock serving stack ------------------------------------------
    log("[9] wall-clock serving: serve_wallclock with the cross-request layer, tracing and "
        "telemetry; replay; the launcher")
    t0 = time.perf_counter()
    wc_launches, fused_in = serve_wallclock_stack(torch, dev, index, embedder, engine.params,
                                                  engine.cfg)
    q, gc_ids, slab, valid, k = fused_in
    e, n = check_ivf(torch, ivf_ops, ivf_ref, q, gc_ids, slab, valid, k, F32,
                     f"fused-plan input G={q.shape[0]} k={k}")
    ivf_err, ivf_ties = max(ivf_err, e), ivf_ties + n
    out_dir = ROOT / "build" / "phase9"
    out_dir.mkdir(parents=True, exist_ok=True)
    run_launcher(out_dir)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f}s")

    # 6. times (last: on the inputs phases 4 and 7 gave the kernels) -------------
    log("[6] times at the paths' inputs (CUDA events, cold L2)")
    t = time_kernels(torch, dev, ivf_in, attn_in, engine, merge_in,
                     fixed_ivf_input(torch, index, tile_len, dev))

    # 10. the MLA + MoE model served at full width and depth ------------------
    # phases 4-9's stacks go first (the recorded attention input holds views
    # of phase 4's cache slab)
    del engine, hybrid, attn_in, aq, ak, av, alen, ivf_in, fused_in, q, slab
    free(torch, dev)
    log(f"[10] {MOE_ARCH} at full width and depth: Server + RealBackend, 8 requests")
    t0 = time.perf_counter()
    moe_launches = serve_moe_path(torch, dev, index, embedder)
    log(f"  phase 10 took {time.perf_counter() - t0:.1f}s")

    # 11. the rest of the zoo at full width ----------------------------------
    log("[11] the zoo at full width: decode vs prefill per family; int8 KV cache")
    t0 = time.perf_counter()
    for w in kernel_wrappers().values():
        w.launches = 0
    zoo_checks(torch, dev)
    zoo_launches = {n: w.launches for n, w in kernel_wrappers().items()}
    log(f"  phase 11 took {time.perf_counter() - t0:.1f}s")

    # 12. training ---------------------------------------------------------
    log("[12] training: qwen3-1.7b at full width and depth; card vs CPU; the zoo's train loss; "
        "checkpoint/resume; gradient compression; the train launcher")
    t0 = time.perf_counter()
    train_launches, _ = train_phase(torch, dev, ROOT / "build" / "phase12")
    log(f"  phase 12 took {time.perf_counter() - t0:.1f}s")

    # 13. the mesh ------------------------------------------------------------
    log(f"[13] the mesh: the dry-run on the production mesh; a {MESH_SHAPE} {MESH_BACKEND} mesh "
        "on the card (train step, decode over the laid-out cache); the launcher through the "
        "host mesh")
    t0 = time.perf_counter()
    mesh_launches, e = mesh_phase(torch, dev, ROOT / "build" / "phase13")
    attn_err = max(attn_err, e)
    log(f"  phase 13 took {time.perf_counter() - t0:.1f}s")

    # launches: phase 4's main path, phase 9's wall-clock run, phase 10's
    # served path, phase 11's zoo and phase 12's training (none), each read
    # with the counts set to 0 just before it; topk_merge's from phase 7
    log(f"  launches: phase 4 {launches}, phase 9 {wc_launches}, phase 10 {moe_launches}, "
        f"phase 11 {zoo_launches}, phase 12 {train_launches}, phase 13 decode_attention by rank "
        f"{mesh_launches}, phase 7 topk_merge {merge_launches}")
    kernels = [
        {"name": "ivf_scan", "route": "cuda", "source": "src/repro_torch/csrc/ivf_scan.cu",
         "replaces": "src/repro/kernels/ivf_scan/ivf_scan.py:111",
         "launches": (launches["ivf_scan"] + wc_launches["ivf_scan"] + moe_launches["ivf_scan"]
                      + train_launches["ivf_scan"]),
         "max_abs_err": ivf_err, **t["ivf_scan"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/decode_attention.py:80",
         "launches": (launches["decode_attention"] + wc_launches["decode_attention"]
                      + moe_launches["decode_attention"] + zoo_launches["decode_attention"]
                      + train_launches["decode_attention"] + sum(mesh_launches.values())),
         "max_abs_err": attn_err,
         **t["decode_attention"]},
        {"name": "topk_merge", "route": "cuda", "source": "src/repro_torch/csrc/topk_merge.cu",
         "replaces": "src/repro/kernels/topk_merge/topk_merge.py:50",
         "launches": merge_launches + train_launches["topk_merge"], "max_abs_err": merge_err,
         **t["topk_merge"]},
    ]
    # the fused kernels of the model body: no Pallas kernel; each replaces the
    # JAX function whose ops XLA fuses (apply_norm, apply_rope with
    # rms_norm_headwise and _scatter_time, apply_ffn's gated product)
    for name, replaces in (("norm", "src/repro/models/layers.py:54"),
                           ("qk_rope", "src/repro/models/layers.py:82"),
                           ("glu", "src/repro/models/layers.py:564")):
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(ph.get(name, 0) for ph in (launches, wc_launches, moe_launches,
                                                        zoo_launches, train_launches)),
            "max_abs_err": fused_err[name], **t[name]})
    log(f"  total {time.perf_counter() - t_all:.1f}s")
    need(all(np.isfinite([r["ms"], r["plain_ms"], r["bound_ms"]]).all() for r in kernels),
         "a time is not finite")
    need(all(r["launches"] > 0 for r in kernels), "a kernel of the path launched no time")
    log(smi_line)  # again, beside the results, for a reader of the output's end
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def mesh_cards(shape) -> int:
    """``--mesh D,M``: phase 13b alone on a (D, M) NCCL mesh, one rank a
    card (D x M cards), the mesh the one-card run cannot have."""
    import math

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from the repository: src/repro_torch is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < math.prod(shape):
        print(f"--mesh {shape} needs {math.prod(shape)} CUDA cards", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"  torch {torch.__version__}; {torch.cuda.device_count()} x "
        f"{torch.cuda.get_device_name(0)}\n{smi.stdout.strip()}")
    launches, err = mesh_on_card(torch, torch.device("cuda"), "nccl", shape)
    log(f"  decode_attention launches by rank {launches}; largest log-sum-exp error {err:.3e}")
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--mesh"]:
            rc = mesh_cards(tuple(int(n) for n in sys.argv[2].split(",")))
        else:
            rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)

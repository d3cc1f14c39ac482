"""Builds the system under test and drives one window of a cell.

The stack is the program's real serving path: ``repro_torch.server.Server``
in hedra mode over ``RealBackend``, which holds a ``GenerationEngine``
(decode step and admissions as captured CUDA graphs) and a
``HybridRetrievalEngine`` (hot clusters scanned on the card by
``ivf_scan``, the rest on the host).  A cell drives it through
``serving.ingress.serve_wallclock`` at speedup 1, with a ``ServingLoop``
built here, whose queue and completions the harness watches.

The harness wraps, from its own files, the backend's ``gen_duration``,
``search_charged`` and ``stage_charged``, the engine's ``step`` and
``add_sequence``, the server's ``step``, and each retrieval plan's
``finalize`` (the scheduler's merge of a sub-stage into each request's
running top-k): for host-clock spans, for the retrieval answers the check
reads, and to feed the engine.  The program
binds no engine sequence to a request: a generation stage decodes whatever
sequences the engine holds.  So before each generation round the harness
admits prompts from the mix until the engine holds as many sequences as
the scheduler's batch (or its slots are full), and counts the rounds where
it could not.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from rag_bench import families

from . import traffic as tr
from .weights import make_params

# tiny sizes for the CPU tests (the plain kernels), with the port's reduced
# model widths
WARM_GEN, WARM_ROUNDS = 4, 6
TINY_DEPLOY = dict(n_docs=4000, dim=32, n_topics=48, n_clusters=32, kmeans_iters=3, nprobe=4,
                   hot=8, max_batch=8, max_len=256, prompt=(24, 96), gen_cap=24,
                   rate_scale=4.0)


class Spans:
    """Host-clock spans of the pump thread: (name, start, end) in monotonic
    seconds, plus ``torch.profiler.record_function`` ranges while a trace
    is open, so the trace can name what the host was doing."""

    def __init__(self):
        self.rows: list = []
        self.profiling = False

    def run(self, name, fn, *args, **kwargs):
        t0 = time.monotonic()
        if self.profiling:
            import torch

            with torch.profiler.record_function(f"rag_bench.{name}"):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        self.rows.append((name, t0, time.monotonic()))
        return out


@dataclasses.dataclass
class SeqRecord:
    """One engine sequence: the left-padded row the engine admitted, its
    prompt, the engine's Sequence (its tokens grow until it retires)."""

    row: np.ndarray
    prompt: np.ndarray
    seq: object
    t_admit: float


def model_config(torch, cfg_file: dict, tiny: bool):
    """The port's ModelConfig for a configuration file, held to the file's
    widths (at the tiny size the port's own reduced widths, in bf16, with
    the family's ``TINY`` overrides); MoE capacity set so that no token is
    dropped (the published routing has no capacity)."""
    from repro_torch.configs import get_config

    mc = get_config(cfg_file["program_arch"])
    if tiny:
        mc = mc.reduced(dtype="bfloat16", **families.load(cfg_file["model_type"]).TINY)
    else:
        check_widths(cfg_file, mc)
    if mc.n_experts:
        mc = dataclasses.replace(mc, capacity_factor=mc.n_experts / mc.moe_top_k)
    return mc


def file_view(cfg_file: dict, mc) -> dict:
    """The configuration file's numbers as the reference reads them: the
    file itself, or at the tiny size its widths replaced by the port's."""
    out = dict(cfg_file)
    out.update(hidden_size=mc.d_model, num_hidden_layers=mc.n_layers,
               num_attention_heads=mc.n_heads, vocab_size=mc.vocab_size)
    out.update(families.load(cfg_file["model_type"]).tiny_view(mc))
    return out


def check_widths(f: dict, mc) -> None:
    """Raise where the port's config departs from the file's widths, as the
    family module reads them (``port``), or its layers from the family's
    (mixer, ffn, repeat) runs."""
    want = dict(d_model=f["hidden_size"], n_layers=f["num_hidden_layers"],
                n_heads=f["num_attention_heads"], vocab_size=f["vocab_size"],
                rope_theta=float(f["rope_theta"]), norm_eps=f["rms_norm_eps"],
                tie_embeddings=f["tie_word_embeddings"], act=f["hidden_act"])
    want.update(families.load(f["model_type"]).port(f))
    have = {k: getattr(mc, k) for k in want}
    have["segments"] = tuple((g.mixer, g.ffn, g.repeat) for g in mc.segments)
    bad = {k: (have[k], v) for k, v in want.items() if have[k] != v}
    if bad:
        raise ValueError(f"the port's {mc.name} departs from the configuration file: {bad}")


@dataclasses.dataclass
class RetRow:
    """One retrieval sub-stage as the program served it: when it ran, its
    plan, the per-item scoreboard, the hot clusters resident at dispatch,
    the request groups in it ((group, request id, round) of each), and the
    program's merged top-k of those groups once its scheduler folds them
    (``merged["res"]``, the ``PlanResult``)."""

    t: float
    plan: object
    items: object
    resident: np.ndarray
    groups: list
    merged: dict


def _record_merge(plan):
    """The request groups of a plan, and a holder that receives the merged
    top-k the scheduler's own ``finalize`` call returns for them."""
    groups, merged = [], {}
    metas = getattr(plan, "group_meta", None)
    if not metas:
        return groups, merged
    for g, meta in enumerate(metas):
        if meta[0] == "ret":
            r = meta[1]
            groups.append((g, int(r.request_id), int(r.round_idx)))
    if groups:
        orig = plan.finalize

        def finalize(results):
            merged["res"] = orig(results)
            return merged["res"]
        plan.finalize = finalize
    return groups, merged


class Stack:
    """The program's serving stack for one cell and seed, and the harness's
    hooks into it."""

    def __init__(self, torch, dev, cfg_file: dict, mix: dict, seed: int, *,
                 req_block: int = tr.BLOCK, tiny: bool = False, log=print):
        from repro_torch.models import lm
        from repro_torch.retrieval import HybridRetrievalEngine, IVFIndex
        from repro_torch.serving.engine import GenerationEngine

        self.torch, self.dev, self.seed, self.mix = torch, dev, seed, mix
        self.log = log
        a = cfg_file["assumed"]
        corpus, ix = dict(a["corpus"]), dict(a["index"])
        max_batch, max_len = a["max_batch"], a["max_len"]
        if tiny:
            t = TINY_DEPLOY
            corpus.update(n_docs=t["n_docs"], dim=t["dim"], n_topics=t["n_topics"])
            ix.update(n_clusters=t["n_clusters"], kmeans_iters=t["kmeans_iters"],
                      nprobe=t["nprobe"], hot_cache_clusters=t["hot"], cache_update_interval=2,
                      cache_transit=0)
            max_batch, max_len = t["max_batch"], t["max_len"]
            mix = dict(mix, prompt_tokens=dict(mix["prompt_tokens"], lo=t["prompt"][0],
                                               hi=t["prompt"][1]),
                       gen_tokens=dict(mix["gen_tokens"], cap=t["gen_cap"],
                                       mean=min(mix["gen_tokens"]["mean"], t["gen_cap"] / 2)))
            self.mix = mix
        self.corpus, self.ix, self.engine_batch = corpus, ix, max_batch
        self.mc = model_config(torch, cfg_file, tiny)
        self.cfg_view = file_view(cfg_file, self.mc)
        t0 = time.monotonic()
        self.params = make_params(torch, lm.init_params(self.mc, device="meta"), seed, dev,
                                  families.load(cfg_file["model_type"]).WEIGHTS)
        self.sync()
        log(f"weights: {sum(1 for _ in _leaf_iter(self.params))} leaves made on {dev} "
            f"in {time.monotonic() - t0:.2f}s")
        t0 = time.monotonic()
        docs, self.topics = tr.make_corpus(torch, corpus, seed, dev)
        self.docs = docs.cpu().numpy()
        del docs
        log(f"corpus {self.docs.shape} made on {dev} in {time.monotonic() - t0:.2f}s")
        t0 = time.monotonic()
        self.index = IVFIndex.build(self.docs, ix["n_clusters"], iters=ix["kmeans_iters"],
                                    seed=seed & 0x7FFFFFFF, device=dev)
        log(f"index: {ix['n_clusters']} clusters built in {time.monotonic() - t0:.2f}s")
        self.hybrid = HybridRetrievalEngine(self.index, cache_capacity=ix["hot_cache_clusters"],
                                            update_interval=ix["cache_update_interval"],
                                            transit_substages=ix["cache_transit"], device=dev)
        t0 = time.monotonic()
        self.engine = GenerationEngine(self.mc, self.params, max_batch=max_batch,
                                       max_len=max_len, eos_id=-1, device=dev)
        self.sync()
        log(f"engine: {max_batch} slots x {max_len}, decode graph captured "
            f"{self.engine._graph is not None}, in {time.monotonic() - t0:.2f}s")
        self.pools = tr.make_pools(mix, corpus["n_topics"], corpus["zipf_alpha"], seed, req_block)
        self.profile = tr.RagProfile(self.pools, mix)
        self.embedder = tr.Embedder(self.topics, self.pools.topic, seed)
        self.spans = Spans()
        self.records: list = []  # SeqRecord of every admitted engine sequence
        self.ret: list = []  # RetRow of every retrieval sub-stage
        self.short_rounds = 0
        self.gen_rounds = 0
        self.admits: list = []  # (start, end, padded width) of every admission
        self.steps: list = []  # (start, end, each active sequence's context) of decode steps
        self.pad_of: dict = {}  # engine seq id -> padded width
        self.step_lens: list = []  # every slot's attention length, decode steps while tracing
        self.scan_calls: list = []  # bytes of each ivf_scan call while tracing
        self._next_prompt = 0
        self._hook_engine()

    # ------------------------------------------------------------ plumbing
    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def _hook_engine(self):
        eng, spans = self.engine, self.spans
        orig_admit, orig_add, orig_step = eng._admit, eng.add_sequence, eng.step
        last_row = {}

        def admit(tokens, slot):
            last_row["row"] = np.array(tokens, copy=True)
            return orig_admit(tokens, slot)

        def add_sequence(prompt, max_new=64):
            t0 = time.monotonic()
            sid = spans.run("admit", orig_add, prompt, max_new=max_new)
            row = last_row.pop("row")
            self.admits.append((t0, time.monotonic(), len(row)))
            self.pad_of[sid] = len(row)
            self.records.append(SeqRecord(row, np.asarray(prompt), eng.seqs[sid], t0))
            return sid

        def step():
            if not eng.seqs:
                return orig_step()
            contexts = [self.pad_of[sid] + len(s.tokens) for sid, s in eng.seqs.items()]
            if spans.profiling:
                self.step_lens.append((eng.state["cache_len"].long() + 1).cpu().numpy())
            t0 = time.monotonic()
            out = spans.run("decode", orig_step)
            self.steps.append((t0, time.monotonic(), contexts))
            return out

        eng._admit, eng.add_sequence, eng.step = admit, add_sequence, step

    def _hook_scan(self):
        """While a trace is open, the bytes of each ``ivf_scan`` call."""
        import repro_torch.retrieval.hybrid as hybrid_mod

        from .peaks import ivf_scan_bytes

        orig = hybrid_mod.ivf_scan

        def scan(q, gc, slab, valid, k):
            if self.spans.profiling:
                g = gc.long().cpu().numpy()
                v = self.hybrid._slab_valid
                rows = int(v[np.unique(g)].sum())
                self.scan_calls.append(ivf_scan_bytes(q.shape[0], q.shape[1], q.shape[2], k,
                                                      rows, slab.shape[0]))
            return orig(q, gc, slab, valid, k)

        hybrid_mod.ivf_scan = scan
        return lambda: setattr(hybrid_mod, "ivf_scan", orig)

    def next_prompt(self):
        k = self._next_prompt
        self._next_prompt += 1
        j = k % len(self.pools.prompt)
        n, max_new = int(self.pools.prompt[j]), int(self.pools.max_new[j])
        toks = tr.rng(self.seed, 2, k).integers(1, self.mc.vocab_size, size=n)
        return toks.astype(np.int64), max_new

    def feed(self, want: int):
        eng = self.engine
        while eng.batch_size < want and eng.can_admit():
            toks, max_new = self.next_prompt()
            eng.add_sequence(toks, max_new=max_new)

    # ------------------------------------------------------------- server
    def build_server(self, profile=None):
        """A fresh ``Server`` over a fresh ``RealBackend`` on the stack's
        engines, with the harness's hooks."""
        from repro_torch.core.backends import RealBackend
        from repro_torch.server import Server

        backend = RealBackend(self.engine, self.index, self.embedder, hybrid=self.hybrid)
        orig_gen, orig_search, orig_stage = (backend.gen_duration, backend.search_charged,
                                             backend.stage_charged)
        spans = self.spans

        def gen_duration(n_prefill_tokens, batch, n_steps):
            t0 = time.perf_counter()
            self.gen_rounds += 1
            self.feed(batch)
            if self.engine.batch_size < batch:
                self.short_rounds += 1
            spans.run("gen", orig_gen, n_prefill_tokens, batch, n_steps)
            return (time.perf_counter() - t0) * 1e6  # admissions and decode, as run

        def search_charged(work, worker_id=0):
            resident = self.hybrid.resident_mask()
            groups, merged = _record_merge(work)
            charge, fn = spans.run("ret", orig_search, work, worker_id)
            self.ret.append(RetRow(time.monotonic(), work, fn(), resident, groups, merged))
            return charge, fn

        def stage_charged(task, worker_id=0):
            return spans.run("stage", orig_stage, task, worker_id)

        backend.gen_duration = gen_duration
        backend.search_charged = search_charged
        backend.stage_charged = stage_charged
        server = Server(self.index, self.embedder, mode="hedra", backend=backend,
                        nprobe=self.ix["nprobe"], num_ret_workers=self.ix["retrieval_workers"],
                        max_gen_batch=self.engine.max_batch, workload=profile or self.profile)
        orig_step = server.step
        server.step = lambda until_us: spans.run("step", orig_step, until_us)
        return server

    def warm_up(self, widths):
        """Set-up's warm-up: one admission at each padded width the mix uses
        (each captures its graph), then rounds of the mix's warm-up requests
        through a server of their own on the virtual clock, with short
        answers, until the hot-cluster cache has swapped clusters in (every
        path runs once; at most WARM_ROUNDS rounds).  The engine sequences still decoding
        when the last warm-up request finishes carry into the window, as
        they would in a server that has been serving."""
        from repro_torch import workflows

        t0 = time.monotonic()
        for w in widths:
            toks = tr.rng(self.seed, 3, w).integers(1, self.mc.vocab_size, size=w)
            self.engine.add_sequence(toks.astype(np.int64), max_new=2)
        self.engine.step_batch(4)
        t1 = time.monotonic()
        # answers of at most WARM_GEN tokens: the warm-up runs every path
        # (retrieval sub-stages fill the hot cache), not the mix's lengths
        server = self.build_server(tr.RagProfile(self.pools, self.mix, gen_cap=WARM_GEN))
        t2 = time.monotonic()
        n, done, rounds = int(self.mix["warmup_requests"]), 0, 0
        base = len(self.pools.rounds) - WARM_ROUNDS * n  # draws the window does not use first
        # rounds of warm-up requests until the hot-cluster cache has swapped
        # clusters in (its refresh comes every so many retrieval sub-stages)
        while rounds < WARM_ROUNDS and (rounds == 0 or not self.hybrid.stats()["swaps"]):
            now = server.sched.now
            for i in range(n):
                j = base + rounds * n + i
                name = self.pools.names[int(self.pools.workflow[j % len(self.pools.rounds)])]
                server.add_request(f"w{j}", workflows.build(name), arrival_us=now + i * 20_000.0)
            done = server.run().finished  # engine sequences still decoding carry into the window
            rounds += 1
        self.sync()
        st = self.hybrid.stats()
        self.log(f"warm-up: admissions at widths {list(widths)} {t1 - t0:.2f}s, server "
                 f"{t2 - t1:.2f}s, {done}/{rounds * n} requests and {len(self.records)} engine "
                 f"sequences {time.monotonic() - t2:.2f}s; hot cache {st['swaps']} swaps, "
                 f"{int(self.hybrid.resident_mask().sum())} clusters resident")
        for rows in (self.records, self.ret, self.spans.rows, self.admits, self.steps):
            rows.clear()
        self.gen_rounds = self.short_rounds = 0

    def widths(self):
        """The padded widths the mix's prompts take (the engine's buckets)."""
        from repro_torch.serving.engine import _bucket

        keep = self.engine.max_len - min(int(self.mix["gen_tokens"]["cap"]),
                                         max(self.engine.max_len // 2, 1))
        return sorted({min(_bucket(int(n)), keep) for n in self.pools.prompt})


def _leaf_iter(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_iter(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_iter(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    t0: float  # monotonic start: the first due arrival's origin
    seconds: float
    due: dict  # text -> due instant (monotonic)
    put: dict  # text -> put stamp (monotonic)
    done: dict  # text -> completion noticed by the pump (monotonic)
    drained_at: float
    timed_out: bool


class _Origin:
    """The ServingLoop clock's source, which records its first reading:
    the window's origin, from which arrivals are due."""

    def __init__(self):
        self.t0 = None

    def __call__(self):
        t = time.monotonic()
        if self.t0 is None:
            self.t0 = t
        return t


def _loop(stack, server, on_tick):
    from repro_torch.serving import ingress

    origin = _Origin()
    loop = ingress.ServingLoop(server, clock=ingress.WallClock(1.0, source=origin))
    put, done, seen = {}, {}, [0]
    orig_put, orig_post = loop.queue.put, loop._post_completions

    def queue_put(kind, t_us, **kw):
        seq = orig_put(kind, t_us, **kw)
        if kind == ingress.ARRIVAL and seq is not None:
            put[kw.get("text", "")] = origin.t0 + t_us / 1e6
        return seq

    def post_completions():
        sched_done = server.sched.done
        for r in sched_done[seen[0]:]:
            done.setdefault(r.state["input"], time.monotonic())
        seen[0] = len(sched_done)
        on_tick(origin.t0)
        return orig_post()

    loop.queue.put, loop._post_completions = queue_put, post_completions
    return loop, origin, put, done


def run_open(stack, server, rate_rps: float, seconds: float, drain_s: float, on_tick):
    from repro_torch.serving import ingress

    sched = tr.open_loop_schedule(stack.mix, stack.pools, rate_rps, seconds)
    stream = [(t * 1e6, f"r{j}", wf) for j, (t, wf) in enumerate(sched)]
    loop, origin, put, done = _loop(stack, server, on_tick)
    timed_out = False
    try:
        ingress.serve_wallclock(server, stream, loop=loop, max_wall_s=seconds + drain_s)
    except TimeoutError:
        timed_out = True
    due = {text: origin.t0 + t_us / 1e6 for t_us, text, _ in stream}
    return Window(origin.t0, seconds, due, put, dict(done), time.monotonic(), timed_out)

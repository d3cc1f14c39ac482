"""The traffic generator: one reader of every mix file in ``traffic/``.

A mix file gives the loop (``open``: arrivals on a schedule), the workflow
shares, the prompt and answer length distributions, the rounds of iterative
workflows, and the base seed of its draws.  The cell file
(``cells/<cell>.json``) gives the open loop's rate.

Every seed gets the same work in another order.  The draws of a mix (each
request's workflow, topic, rounds and answer lengths, each engine
sequence's prompt length and answer cap) are made once from the mix's
``base_seed`` into pools, which ``--seed`` permutes within blocks (an open
loop's block is its window's arrival count: every seed serves the same
requests); an open loop's arrivals are a fixed count at the cell's rate
whose gaps the seed orders.  The seed also draws the content (the prompt tokens, the
query vectors and the corpus).  Runs of different seeds then differ in
what they compute, not in how much.

The arithmetic below is a frozen copy of the program's generators
(``serving/workload.py``: ``MixSpec.sample``'s gaps and class picks,
``poisson_arrivals``, ``WorkloadProfile``'s
lognormal lengths; ``retrieval/synthetic.py``: ``make_corpus`` and
``SyntheticEmbedder``), so that a change to the program cannot move the
yardstick.  The corpus is made on the device, in a few large calls.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

SEED_MASK = (1 << 63) - 1


def seed_seq(*parts) -> np.random.SeedSequence:
    """A SeedSequence over non-negative parts (a seed may exceed 32 bits)."""
    return np.random.SeedSequence([int(p) & SEED_MASK for p in parts])


def rng(*parts) -> np.random.Generator:
    return np.random.default_rng(seed_seq(*parts))


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def zipf_pops(n: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    pops = ranks ** (-alpha)
    return pops / pops.sum()


# ---------------------------------------------------------------------------
# lengths
# ---------------------------------------------------------------------------


def draw_lengths(spec: dict, r: np.random.Generator, n: int) -> np.ndarray:
    """``n`` lengths of a mix's length spec: ``log_uniform`` in [lo, hi], or
    ``lognormal`` around ``mean`` clipped to [min, cap] (the program's
    ``WorkloadProfile.gen_tokens``)."""
    if spec["dist"] == "log_uniform":
        lo, hi = math.log(spec["lo"]), math.log(spec["hi"])
        v = np.exp(r.uniform(lo, hi, size=n)).round().astype(np.int64)
        return v.clip(spec["lo"], spec["hi"])
    if spec["dist"] == "lognormal":
        v = r.lognormal(np.log(spec["mean"]), spec["sigma"], size=n)
        return np.clip(v, spec.get("min", 1), spec["cap"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


@dataclasses.dataclass
class Pools:
    """A mix's draws from its base seed, permuted by the run's seed."""

    seed: int  # the run's
    workflow: np.ndarray  # (pool,) index into names
    names: list
    topic: np.ndarray  # (pool,) topic rank, Zipf over the corpus topics
    rounds: np.ndarray  # (pool,)
    gen: np.ndarray  # (pool, 8) answer lengths of a request's generation nodes
    prompt: np.ndarray  # (pool,) engine sequences' prompt lengths
    max_new: np.ndarray  # (pool,) engine sequences' answer caps


BLOCK = 32  # the run's seed permutes each pool within blocks of this many draws


def _blockwise(a: np.ndarray, r: np.random.Generator) -> np.ndarray:
    """``a`` permuted within consecutive blocks of BLOCK: every prefix of
    whole blocks holds the same draws whatever the permutation."""
    out = a.copy()
    for lo in range(0, len(a), BLOCK):
        out[lo: lo + BLOCK] = a[lo: lo + BLOCK][r.permutation(min(BLOCK, len(a) - lo))]
    return out


def _balanced(names: list, w: np.ndarray, n: int, block: int) -> np.ndarray:
    """Workflow indices: the shares exactly (largest remainder) in every
    block, the block's remainder rotating over the workflows."""
    share = block * w / w.sum()
    base = np.floor(share).astype(np.int64)
    extra = np.argsort(-(share - base), kind="stable")
    out = []
    for b in range(-(-n // block)):
        counts = base.copy()
        counts[np.roll(extra, -b)[: block - counts.sum()]] += 1
        out.append(np.repeat(np.arange(len(names)), counts))
    return np.concatenate(out)[:n]


def make_pools(mix: dict, n_topics: int, zipf_alpha: float, seed: int,
               req_block: int = BLOCK) -> Pools:
    """The mix's pools for a run.  Request draws are permuted within blocks
    of ``req_block`` (an open loop passes its window's arrival count, so
    that every seed serves the very same requests in another order), the
    engine's prompt draws within blocks of BLOCK."""
    pool = int(mix["pool"])
    r = rng(mix["base_seed"])
    names = sorted(mix["workflows"])
    w = np.asarray([mix["workflows"][c] for c in names], np.float64)
    workflow = _balanced(names, w, pool, req_block)
    topic = r.choice(n_topics, size=pool, p=zipf_pops(n_topics, zipf_alpha))
    rounds = np.clip(1 + r.poisson(max(mix["rounds"]["mean"] - 1.0, 0.0), size=pool), 1,
                     mix["rounds"]["max"])
    gen = draw_lengths(mix["gen_tokens"], r, pool * 8).reshape(pool, 8)
    prompt = draw_lengths(mix["prompt_tokens"], r, pool)
    max_new = draw_lengths(mix["gen_tokens"], r, pool)
    p = rng(seed, 1)
    perm = np.concatenate([lo + p.permutation(min(req_block, pool - lo))
                           for lo in range(0, pool, req_block)])
    return Pools(seed=int(seed), workflow=workflow[perm], names=names, topic=topic[perm],
                 rounds=rounds[perm], gen=gen[perm], prompt=_blockwise(prompt, p),
                 max_new=_blockwise(max_new, p))


# ---------------------------------------------------------------------------
# the scheduler's view of a request: the program's WorkloadProfile interface
# ---------------------------------------------------------------------------


class RagProfile:
    """What the scheduler asks of a request (``WorkloadProfile``'s methods),
    answered from the pools by request id: the program assigns ids in
    arrival order, so request ``j`` is the mix's ``j``-th draw."""

    name = "rag_bench"

    def __init__(self, pools: Pools, mix: dict, gen_cap: int | None = None):
        self.p, self.mix = pools, mix
        self.cap = int(mix["gen_tokens"]["cap"] if gen_cap is None else gen_cap)
        self.slo_class_us: dict = {}

    def _j(self, request_id: int) -> int:
        return int(request_id) % len(self.p.rounds)

    def prompt_tokens(self, request_id: int, node_id: int) -> int:
        return int(self.p.prompt[(self._j(request_id) + 7 * node_id) % len(self.p.prompt)])

    def gen_tokens(self, request_id: int, node_id: int, cap: int) -> int:
        v = int(self.p.gen[self._j(request_id), node_id % self.p.gen.shape[1]])
        return int(np.clip(v, min(self.mix["gen_tokens"].get("min", 1), self.cap),
                           min(cap, self.cap)))

    def iterations(self, request_id: int) -> int:
        return int(self.p.rounds[self._j(request_id)])

    def slo_us(self, request_id: int, workflow=None) -> float:
        return 0.0  # the scheduler's default deadline; nothing is shed


def open_loop_schedule(mix: dict, pools: Pools, rate_rps: float, seconds: float) -> list:
    """``(due_s, workflow)`` of the window's arrivals: ``n = round(rate *
    seconds)`` of them, the gaps ``n`` exponential draws from the mix's base
    seed (``MixSpec.sample``'s Poisson gaps), scaled so that the n-th
    arrival falls at ``seconds * n / (n + 1)`` and ordered by the run's
    seed; the workflows in pool order.  Every seed offers the same load."""
    n = max(1, int(round(rate_rps * seconds)))
    gaps = rng(mix["base_seed"], 6, n).exponential(1.0, size=n)
    gaps = gaps[rng(pools.seed, 7).permutation(n)]
    due = np.cumsum(gaps) * (seconds * n / (n + 1) / gaps.sum())
    return [(float(due[j]), pools.names[int(pools.workflow[j])]) for j in range(n)]


# ---------------------------------------------------------------------------
# corpus and embedder (retrieval/synthetic.py's arithmetic)
# ---------------------------------------------------------------------------


def make_corpus(torch, corpus: dict, seed: int, device):
    """(docs (N, d) f32 unit rows on ``device``, topic vectors (T, d) numpy):
    ``make_corpus``'s mixture of Zipf-popular topics, drawn on the device
    from ``seed`` in a few large calls."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    n, d, T = corpus["n_docs"], corpus["dim"], corpus["n_topics"]
    topics = torch.randn((T, d), generator=gen, device=device)
    topics /= topics.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    pops = torch.as_tensor(zipf_pops(T, corpus["zipf_alpha"]), dtype=torch.float32, device=device)
    doc_topic = torch.multinomial(pops, n, replacement=True, generator=gen)
    docs = torch.randn((n, d), generator=gen, device=device)
    docs.mul_(corpus["doc_noise"]).add_(topics[doc_topic])
    docs /= docs.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    return docs, topics.cpu().numpy()


@dataclasses.dataclass
class Embedder:
    """``SyntheticEmbedder``'s query process (a bounded random walk around
    the request's topic, partial generations converging to the final
    embedding), with the request's topic taken from the pools."""

    topic_vecs: np.ndarray
    topic_of: np.ndarray  # pools.topic
    seed: int
    inter_drift: float = 0.25
    query_noise: float = 0.30
    partial_noise: float = 0.8
    decay_pow: float = 1.5

    def __post_init__(self):
        self.dim = int(self.topic_vecs.shape[1])

    def _rng(self, request_id: int, tag: int) -> np.random.Generator:
        return rng(self.seed, request_id, tag)

    def request_topic(self, request_id: int) -> int:
        return int(self.topic_of[int(request_id) % len(self.topic_of)])

    def embed_query(self, request_id: int, round_idx: int) -> np.ndarray:
        base = self.topic_vecs[self.request_topic(request_id)]
        anchor = base + self.query_noise * self._rng(request_id, 1).standard_normal(self.dim)
        walk = np.zeros(self.dim, np.float64)
        for r in range(1, round_idx + 1):
            step = self._rng(request_id, 100 + r).standard_normal(self.dim)
            walk += self.inter_drift * step / np.sqrt(self.dim) * np.linalg.norm(anchor)
        return _unit((anchor + walk)[None, :].astype(np.float32))[0]

    def embed_partial(self, request_id: int, round_idx: int, ratio: float) -> np.ndarray:
        final = self.embed_query(request_id, round_idx)
        resid = self._rng(request_id, 200 + round_idx).standard_normal(self.dim)
        amp = self.partial_noise * (1.0 - min(max(ratio, 0.0), 1.0)) ** self.decay_pow
        return _unit((final + amp * resid / np.sqrt(self.dim) * np.linalg.norm(final))[None, :])[0]

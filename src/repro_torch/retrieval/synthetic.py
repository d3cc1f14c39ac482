"""Synthetic corpus + embedder with controllable RAG phenomenology.

The paper measures three workload phenomena on Wikipedia/e5-large that drive
its optimizations; offline we reproduce each with explicit knobs:

* **cluster access skew** (Fig. 8): topics drawn from a Zipf distribution so
  a small subset of IVF clusters absorbs most probes;
* **inter-retrieval similarity** (Fig. 7a): successive queries of one request
  are a bounded random walk around the request's topic vector;
* **intra-generation similarity** (Fig. 7b): the embedding of a partial
  generation converges to the final generation embedding as the prefix ratio
  grows.

Real-corpus integration point: anything implementing ``Embedder`` can replace
``SyntheticEmbedder`` (e.g. an e5 checkpoint wrapped in a jitted encoder).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

import numpy as np


class Embedder(Protocol):
    dim: int

    def embed_query(self, request_id: int, round_idx: int) -> np.ndarray: ...

    def embed_partial(self, request_id: int, round_idx: int, ratio: float) -> np.ndarray: ...


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


@dataclasses.dataclass
class CorpusConfig:
    n_docs: int = 100_000
    dim: int = 256
    n_topics: int = 512
    zipf_alpha: float = 1.1      # topic popularity skew
    doc_noise: float = 0.35      # doc spread around its topic vector
    seed: int = 0


def make_corpus(cfg: CorpusConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (doc_vectors (N, d) f32 unit-norm, doc_topic (N,), topic_vecs)."""
    rng = np.random.default_rng(cfg.seed)
    topics = _unit(rng.standard_normal((cfg.n_topics, cfg.dim)).astype(np.float32))
    # Zipf-ish popularity over topics
    ranks = np.arange(1, cfg.n_topics + 1, dtype=np.float64)
    pops = ranks ** (-cfg.zipf_alpha)
    pops /= pops.sum()
    doc_topic = rng.choice(cfg.n_topics, size=cfg.n_docs, p=pops).astype(np.int32)
    docs = topics[doc_topic] + cfg.doc_noise * rng.standard_normal(
        (cfg.n_docs, cfg.dim)
    ).astype(np.float32)
    return _unit(docs).astype(np.float32), doc_topic, topics


@dataclasses.dataclass
class DuplicateTrafficEmbedder:
    """Wrapper modelling cross-user duplicate/near-duplicate query traffic.

    A ``dup_ratio`` fraction of requests re-issue a *canonical* query drawn
    Zipf-style from a small trending pool (the inter-request skewness of
    paper §4.4 applied to the query stream itself — at millions of users,
    lookalike queries are the common case).  ``near_jitter > 0`` perturbs
    duplicates into near-duplicates with a controlled cosine distance, which
    is what the crossreq dedup threshold and the global cache's ball-bound
    answers are calibrated against.

    ``canonical_id`` is exposed so workloads can keep duplicate requests on
    the same workflow (same query -> same pipeline) and benchmarks can
    assert fused answers against independently executed searches.
    """

    base: "Embedder"
    dup_ratio: float = 0.3
    pool_size: int = 8
    near_jitter: float = 0.0
    zipf_alpha: float = 1.1
    seed: int = 77

    # canonical queries live in a reserved request-id space far above any
    # real request id, so they never collide with organic traffic
    _POOL_BASE = 10_000_000

    def __post_init__(self):
        self.dim = self.base.dim
        ranks = np.arange(1, self.pool_size + 1, dtype=np.float64)
        pops = ranks ** (-self.zipf_alpha)
        self._pops = pops / pops.sum()

    def canonical_id(self, request_id: int) -> int:
        """The id whose query stream this request re-issues (itself when the
        request is organic, a pool id when it is duplicate traffic)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, request_id]))
        if rng.random() < self.dup_ratio:
            return self._POOL_BASE + int(
                rng.choice(self.pool_size, p=self._pops))
        return request_id

    def is_duplicate(self, request_id: int) -> bool:
        return self.canonical_id(request_id) != request_id

    def _jitter(self, vec: np.ndarray, request_id: int, tag: int) -> np.ndarray:
        if self.near_jitter <= 0.0:
            return vec
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, request_id, tag]))
        noise = rng.standard_normal(self.dim) / np.sqrt(self.dim)
        return _unit((vec + self.near_jitter * noise)[None, :].astype(np.float32))[0]

    def embed_query(self, request_id: int, round_idx: int) -> np.ndarray:
        cid = self.canonical_id(request_id)
        v = self.base.embed_query(cid, round_idx)
        if cid == request_id:
            return v
        return self._jitter(v, request_id, 300 + round_idx)

    def embed_partial(self, request_id: int, round_idx: int, ratio: float) -> np.ndarray:
        cid = self.canonical_id(request_id)
        v = self.base.embed_partial(cid, round_idx, ratio)
        if cid == request_id:
            return v
        return self._jitter(v, request_id, 400 + round_idx)


@dataclasses.dataclass
class SyntheticEmbedder:
    """Per-request query/generation embedding process (see module docstring).

    inter_drift:  distance between consecutive round queries (Fig. 7a knob)
    partial_noise: residual distance of a ratio-r partial generation to the
                   final generation embedding decays as (1-r)**decay_pow.
    """

    topic_vecs: np.ndarray
    zipf_alpha: float = 1.1
    inter_drift: float = 0.25
    query_noise: float = 0.30
    partial_noise: float = 0.8
    decay_pow: float = 1.5
    seed: int = 1234

    def __post_init__(self):
        self.dim = int(self.topic_vecs.shape[1])
        n_topics = self.topic_vecs.shape[0]
        ranks = np.arange(1, n_topics + 1, dtype=np.float64)
        pops = ranks ** (-self.zipf_alpha)
        self._pops = pops / pops.sum()

    def _rng(self, request_id: int, tag: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, request_id, tag])
        )

    def request_topic(self, request_id: int) -> int:
        rng = self._rng(request_id, 0)
        return int(rng.choice(len(self._pops), p=self._pops))

    def embed_query(self, request_id: int, round_idx: int) -> np.ndarray:
        """Round-r retrieval query: random walk around the request topic."""
        t = self.request_topic(request_id)
        base = self.topic_vecs[t]
        rng0 = self._rng(request_id, 1)
        anchor = base + self.query_noise * rng0.standard_normal(self.dim)
        # bounded random walk: each round drifts by inter_drift from previous
        walk = np.zeros(self.dim, np.float64)
        for r in range(1, round_idx + 1):
            step = self._rng(request_id, 100 + r).standard_normal(self.dim)
            walk += self.inter_drift * step / np.sqrt(self.dim) * np.linalg.norm(anchor)
        return _unit((anchor + walk)[None, :].astype(np.float32))[0]

    def embed_partial(self, request_id: int, round_idx: int, ratio: float) -> np.ndarray:
        """Embedding of a partial generation with prefix ratio in [0, 1]."""
        final = self.embed_query(request_id, round_idx)
        resid = self._rng(request_id, 200 + round_idx).standard_normal(self.dim)
        amp = self.partial_noise * (1.0 - min(max(ratio, 0.0), 1.0)) ** self.decay_pow
        return _unit((final + amp * resid / np.sqrt(self.dim) * np.linalg.norm(final))[None, :])[0]

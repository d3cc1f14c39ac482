"""Deterministic lexical (term-overlap) scoring channel + rank fusion.

The dense IVF path models the semantic retrieval channel; hybrid workflows
additionally score candidates lexically and fold the two orders together
(``RetrievalNode.lexical_weight > 0``).  Real deployments run BM25 here; the
repro needs the same *shape* — a second, query-text-keyed ranking signal
that is deterministic across runs and backends — without a token corpus, so
the scorer synthesises one:

* every doc owns a seeded Zipf-skewed term multiset (low term ids are
  common, high ids rare), derived lazily from the doc id alone;
* a query's terms derive from a stable hash of its text with the same skew;
* score = idf-weighted overlap, idf rising with term rarity.

Identical (text, doc) pairs therefore score identically everywhere, which is
what the serving fingerprints and cross-backend parity tests need.

``rrf_fuse`` is standard weighted reciprocal-rank fusion over the dense
order and the lexical reorder; ``weight=0`` is the identity (pure dense).
"""
from __future__ import annotations

import hashlib

import numpy as np

_SKEW = 2.5  # u**_SKEW biases draws toward low (common) term ids


class LexicalScorer:
    """Synthetic-but-deterministic lexical channel over integer doc ids."""

    def __init__(self, vocab_size: int = 4096, doc_terms: int = 24,
                 query_terms: int = 8, seed: int = 101):
        self.vocab_size = int(vocab_size)
        self.doc_terms = int(doc_terms)
        self.query_terms = int(query_terms)
        self.seed = int(seed)
        self._doc_cache: dict[int, np.ndarray] = {}

    # ----------------------------------------------------------- term sets
    def _skewed(self, u: np.ndarray) -> np.ndarray:
        t = (self.vocab_size * np.asarray(u, np.float64) ** _SKEW)
        return np.minimum(t.astype(np.int64), self.vocab_size - 1)

    def doc_term_set(self, doc_id: int) -> np.ndarray:
        terms = self._doc_cache.get(doc_id)
        if terms is None:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 1, int(doc_id)]))
            terms = np.unique(self._skewed(rng.random(self.doc_terms)))
            self._doc_cache[doc_id] = terms
        return terms

    def query_term_set(self, text: str) -> np.ndarray:
        h = hashlib.sha256(str(text).encode("utf-8")).digest()
        u = np.frombuffer(h[: 4 * self.query_terms], np.uint32).astype(
            np.float64) / float(2**32)
        return np.unique(self._skewed(u[: self.query_terms]))

    def idf(self, terms: np.ndarray) -> np.ndarray:
        # low ids are drawn often (the skew above), so rarity — and idf —
        # rises with the term id
        return np.log1p((np.asarray(terms, np.float64) + 1.0)
                        / float(self.vocab_size))

    # -------------------------------------------------------------- scoring
    def scores(self, text: str, doc_ids) -> dict:
        """idf-weighted term overlap for each candidate doc."""
        q = self.query_term_set(text)
        qidf = self.idf(q)
        out = {}
        for d in doc_ids:
            d = int(d)
            hit = np.isin(q, self.doc_term_set(d), assume_unique=True)
            out[d] = float(qidf[hit].sum())
        return out


def rrf_fuse(dense_ids, lex_scores: dict, weight: float,
             c: float = 60.0) -> list:
    """Weighted reciprocal-rank fusion: fold the dense order (rank = list
    position) with the lexical reorder of the same candidate set.  Returns
    the identical id set, reordered; ties break on doc id so the fold is
    deterministic."""
    dense_ids = [int(d) for d in dense_ids]
    lex_order = sorted(dense_ids,
                       key=lambda d: (-lex_scores.get(d, 0.0), d))
    lex_rank = {d: i for i, d in enumerate(lex_order)}
    w = float(weight)
    fused = {
        d: (1.0 - w) / (c + i) + w / (c + lex_rank[d])
        for i, d in enumerate(dense_ids)
    }
    return sorted(dense_ids, key=lambda d: (-fused[d], d))

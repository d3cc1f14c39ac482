"""Speculative execution across dependent stages (paper §4.3, C5).

Two directions:

* **speculative generation** — a Retrieval→Generation edge: once a prefix of
  the (reordered) cluster queue has been searched, the follower generation
  starts from the *partial* top-k.  When the retrieval completes, partial and
  final top-k are compared; mismatch rolls the generation back (it overlapped
  with remaining search, so rollback costs nothing vs. the sequential plan).

* **speculative retrieval** — a Generation→Retrieval edge: the embedding of a
  partial generation (ratio r of expected tokens) launches a warm-up search
  whose results populate the request's LocalCache, so the *real* retrieval
  starts with inter-retrieval history (reordering + O1 cache answers).

Trigger policy (paper): speculate only while the next sub-stage leaves the
engine underutilised — T_curr / T_max < tau — and then pick candidates with
the lowest expected speculation error:

  spec-gen:  retrieval whose running top-k distances are closest to the query
             (small kth distance -> partial result likely final);
  spec-ret:  generation with minimal semantic drift between consecutive
             partial embeddings.

Baseline policies from the paper's comparison are expressible in the same
machinery (the paper itself implements them as speculative edges):
  'ralmspec'  — always speculate from the local cache, no reordering gate;
  'pipeline'  — PipeRAG/RAGCache-style conservative fixed-point speculation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SpeculationPolicy:
    mode: str = "hedra"  # hedra | ralmspec | pipeline | off
    tau: float = 0.85  # throughput-underutilisation gate
    min_searched_frac: float = 0.25  # spec-gen: prefix of clusters searched
    spec_ret_ratio: float = 0.4  # spec-ret: partial-generation ratio
    max_spec_per_cycle: int = 4
    kth_dist_margin: float = 1.25  # spec-gen candidate quality filter

    @property
    def enabled(self) -> bool:
        return self.mode != "off"


@dataclasses.dataclass
class SpecStats:
    attempted_gen: int = 0
    validated_gen: int = 0
    rolled_back_gen: int = 0
    attempted_ret: int = 0
    useful_ret: int = 0

    @property
    def gen_accuracy(self) -> float:
        n = self.validated_gen + self.rolled_back_gen
        return self.validated_gen / n if n else 0.0


class Speculator:
    def __init__(self, policy: SpeculationPolicy):
        self.policy = policy
        self.stats = SpecStats()

    # ------------------------------------------------------------- gating
    def throughput_gate(self, t_curr: float, t_max: float) -> bool:
        if not self.policy.enabled:
            return False
        if self.policy.mode == "ralmspec":
            return True  # RaLMSpec speculates unconditionally
        return (t_curr / max(t_max, 1e-9)) < self.policy.tau

    # ----------------------------------------------------- candidate scoring
    def spec_gen_ready(self, searched: int, total: int, kth_dist: float,
                       centroid_d0: float) -> bool:
        """Is this retrieval stage a good speculative-generation basis?"""
        if total == 0:
            return False
        frac = searched / total
        if self.policy.mode == "pipeline":
            # conservative: only speculate once most clusters are done
            return frac >= 0.75
        if frac < self.policy.min_searched_frac:
            return False
        if self.policy.mode == "ralmspec":
            return True
        # hedra: quality filter — partial kth distance must already be tight
        # relative to the first-centroid distance scale
        return np.isfinite(kth_dist) and kth_dist <= self.policy.kth_dist_margin * max(
            centroid_d0, 1e-9
        )

    def rank_spec_gen(self, cands: list) -> list:
        """Sort candidates by (kth partial distance / scale): tightest first."""
        return sorted(cands, key=lambda c: c[0])

    # -------------------------------------------------------------- validate
    def validate_gen(self, basis_ids: np.ndarray, final_ids: np.ndarray) -> bool:
        ok = bool(np.array_equal(np.asarray(basis_ids), np.asarray(final_ids)))
        if ok:
            self.stats.validated_gen += 1
        else:
            self.stats.rolled_back_gen += 1
        return ok

    # ---------------------------------------------------------------- drift
    @staticmethod
    def semantic_drift(prev_emb: Optional[np.ndarray], cur_emb: np.ndarray) -> float:
        if prev_emb is None:
            return float("inf")
        return float(np.linalg.norm(prev_emb - cur_emb))

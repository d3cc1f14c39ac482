"""Structure-of-arrays retrieval plans: the vectorized sub-stage executor.

A :class:`RetrievalPlan` is one retrieval-worker job flattened into arrays.
It replaces the per-item ``list[(query, cluster, TopK)]`` protocol (one
Python ``TopK`` object and two ``merge()`` allocations per work item) with a
layout the whole sub-stage path can operate on at numpy speed:

* **items** — one row per (query, cluster) probe.  ``queries`` is the stacked
  ``(n_items, d)`` matrix, ``cluster_ids`` the probed cluster per row.
* **segment table** — items sorted by cluster (``seg_order``) and segmented
  into unique-cluster runs (``seg_cluster``, ``seg_bounds``).  Each cluster
  block is GEMM-scanned exactly once per sub-stage and the result rows are
  shared by every query probing that cluster, on either the host or the
  device path.
* **scoreboard** — a :class:`BatchTopK`: ``(n_items, k)`` dists/ids arrays.
  Merging a batch of candidate rows is a single ``np.argpartition`` over the
  concatenated candidate axis — no per-item allocation.
* **groups** — consecutive items belonging to one logical search (a request
  sub-stage, a speculative warmup, one query of a batched full search).
  ``finalize()`` folds the per-item rows back into one running top-k per
  group with the same sequential-merge semantics (and therefore the same
  per-cluster improvement streaks) as the scalar ``TopK.merge`` chain, but
  vectorized across all groups.

The plan carries everything completion needs (seeds, early-termination
streak state, opaque ``meta`` tags mapping groups back to (request, node)),
so the scheduler consumes results with one vectorized scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.retrieval.ivf import TopK

_EPS = 1e-12  # improvement threshold shared with the scalar streak logic

# finalize(): above this (n_groups * W * g_max) element count the dense 3-D
# streak-recovery tensor would dominate memory (coarse whole-stage jobs with
# large nprobe), so the equivalent sequential per-step merge is used instead
_STREAK_TENSOR_MAX = 2_000_000


# ---------------------------------------------------------------------------
# Batched running top-k (SoA scoreboard)
# ---------------------------------------------------------------------------


class BatchTopK:
    """Running top-k for ``n`` items as two ``(n, k)`` arrays.

    Rows are kept ascending by distance, ``+inf``/``-1`` padded — row ``i``
    is bit-compatible with ``TopK(k, dists[i], ids[i])``.  ``merge_rows``
    folds a ``(m, c)`` candidate block into ``m`` rows at once.
    """

    __slots__ = ("k", "dists", "ids")

    def __init__(self, k: int, dists: np.ndarray, ids: np.ndarray):
        self.k = int(k)
        self.dists = dists
        self.ids = ids

    @classmethod
    def empty(cls, n: int, k: int) -> "BatchTopK":
        return cls(
            k,
            np.full((n, k), np.inf, np.float32),
            np.full((n, k), -1, np.int64),
        )

    @property
    def n(self) -> int:
        return self.dists.shape[0]

    def merge_rows(
        self, rows: np.ndarray, cand_d: np.ndarray, cand_i: np.ndarray
    ) -> None:
        """Merge candidates ``cand_d/cand_i`` (m, c) into rows ``rows`` (m,).

        One argpartition over the concatenated ``k + c`` candidate axis for
        all m rows, then one stable sort — the exact batched analogue of
        ``TopK.merge`` (current entries concatenated first, so tie behaviour
        matches the scalar path).
        """
        if cand_d.size == 0 or rows.size == 0:
            return
        k = self.k
        d = np.concatenate(
            [self.dists[rows], np.asarray(cand_d, np.float32)], axis=1)
        i = np.concatenate(
            [self.ids[rows], np.asarray(cand_i, np.int64)], axis=1)
        if d.shape[1] > k:
            sel = np.argpartition(d, k - 1, axis=1)[:, :k]
            d = np.take_along_axis(d, sel, axis=1)
            i = np.take_along_axis(i, sel, axis=1)
        order = np.argsort(d, axis=1, kind="stable")
        self.dists[rows] = np.take_along_axis(d, order, axis=1)
        self.ids[rows] = np.take_along_axis(i, order, axis=1)

    def row(self, i: int, k: Optional[int] = None) -> TopK:
        """Materialise one row as a scalar ``TopK`` (trimmed to ``k``)."""
        kk = self.k if k is None else int(k)
        return TopK(kk, self.dists[i, :kk].copy(), self.ids[i, :kk].copy())


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanResult:
    """Per-group outcome of ``RetrievalPlan.finalize``."""

    dists: np.ndarray  # (n_groups, k) merged running top-k, ascending
    ids: np.ndarray  # (n_groups, k)
    last_kth: np.ndarray  # (n_groups,) kth distance at the last improvement
    no_improve: np.ndarray  # (n_groups,) trailing no-improvement streak

    def group_topk(self, g: int, k: int) -> TopK:
        return TopK(int(k), self.dists[g, :k].copy(), self.ids[g, :k].copy())


@dataclasses.dataclass
class RetrievalPlan:
    """One flattened retrieval job (see module docstring for the layout)."""

    queries: np.ndarray  # (n_items, d) f32 — one row per (query, cluster)
    q_norms: np.ndarray  # (n_items,) f32 — ||q||^2 cached at build time
    cluster_ids: np.ndarray  # (n_items,) i64
    k: int  # scoreboard width = max group k
    item_group: np.ndarray  # (n_items,) i64 — owning group per item
    group_start: np.ndarray  # (n_groups + 1,) i64 — items of g: [s[g], s[g+1])
    group_k: np.ndarray  # (n_groups,) i64 — requested k per group
    # (n_groups,) i64 — logical searches served per group: a crossreq-fused
    # group executes once but answers `fanout` subscriber requests; backends
    # charge the group once and account the avoided duplicate work
    group_fanout: np.ndarray
    group_meta: list  # opaque per-group tags (request/node/spec binding)
    seed_dists: np.ndarray  # (n_groups, k) f32 — running top-k at assembly
    seed_ids: np.ndarray  # (n_groups, k) i64
    group_last_kth: np.ndarray  # (n_groups,) f64 — streak state at assembly
    group_no_improve: np.ndarray  # (n_groups,) i64
    # segment table: items grouped by probed cluster
    seg_order: np.ndarray  # (n_items,) permutation, cluster-sorted
    seg_cluster: np.ndarray  # (n_seg,) unique cluster ids, ascending
    seg_bounds: np.ndarray  # (n_seg + 1,) ranges into seg_order

    @property
    def n_items(self) -> int:
        return int(self.cluster_ids.shape[0])

    @property
    def n_groups(self) -> int:
        return int(self.group_k.shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.seg_cluster.shape[0])

    def seg_counts(self) -> np.ndarray:
        """Queries probing each segment's cluster (for vectorized charging)."""
        return self.seg_bounds[1:] - self.seg_bounds[:-1]

    def segment_rows(self, s: int) -> np.ndarray:
        """Item rows probing segment ``s``'s cluster."""
        return self.seg_order[self.seg_bounds[s]: self.seg_bounds[s + 1]]

    # ------------------------------------------------------------- completion
    def finalize(self, results: BatchTopK) -> PlanResult:
        """Fold per-item rows into per-group running top-k + streaks.

        One stable sort over each group's ``[seed | item 0 | item 1 | ...]``
        candidate axis replaces the sequential per-cluster merge chain; the
        per-cluster kth sequence the early-termination streak needs is
        recovered with a vectorized prefix count over the sorted step labels.
        The outcome (including tie order — truncation to top-k commutes with
        the stable concatenation order) matches the scalar
        ``TopK.merge``-per-cluster chain exactly.
        """
        k = self.k
        n_g = self.n_groups
        sizes = self.group_start[1:] - self.group_start[:-1]
        g_max = int(sizes.max()) if sizes.size else 0
        ref = self.group_last_kth.astype(np.float64).copy()
        noimp = self.group_no_improve.astype(np.int64).copy()
        if g_max == 0 or results.n == 0:
            return PlanResult(
                self.seed_dists.copy(), self.seed_ids.copy(), ref, noimp)
        if n_g * (g_max + 1) * k * g_max > _STREAK_TENSOR_MAX:
            return self._finalize_sequential(results, sizes, g_max, ref, noimp)
        # candidate matrix: seed in columns [0, k), item j in
        # [(j+1)k, (j+2)k) — one fancy scatter for all items
        W = (g_max + 1) * k
        cd = np.full((n_g, W), np.inf, np.float32)
        ci = np.full((n_g, W), -1, np.int64)
        cd[:, :k] = self.seed_dists
        ci[:, :k] = self.seed_ids
        slot = np.arange(self.n_items) - self.group_start[self.item_group] + 1
        cols = slot[:, None] * k + np.arange(k)[None, :]
        cd[self.item_group[:, None], cols] = results.dists
        ci[self.item_group[:, None], cols] = results.ids
        order = np.argsort(cd, axis=1, kind="stable")
        ds = np.take_along_axis(cd, order, axis=1)
        is_ = np.take_along_axis(ci, order, axis=1)
        # kth after each step j = group_k-th smallest among candidates with
        # step label <= j (label: seed -1, item j -> j)
        lab = order // k - 1  # (n_g, W) sorted step labels
        mask = lab[:, :, None] <= np.arange(g_max)[None, None, :]
        cum = mask.cumsum(axis=1, dtype=np.int32)
        hit = cum == self.group_k[:, None, None].astype(np.int32)
        pos = hit.argmax(axis=1)  # (n_g, g_max) first index reaching k_g
        kth_seq = ds[np.arange(n_g)[:, None], pos].astype(np.float64)
        for j in range(g_max):
            act = sizes > j
            imp = act & (kth_seq[:, j] < ref - _EPS)
            ref[imp] = kth_seq[imp, j]
            noimp[imp] = 0
            noimp[act & ~imp] += 1
        return PlanResult(
            np.ascontiguousarray(ds[:, :k]),
            np.ascontiguousarray(is_[:, :k]),
            ref, noimp)

    def _finalize_sequential(self, results, sizes, g_max, ref, noimp):
        """Equivalent fold without the dense streak tensor: one vectorized
        merge per item *position* (every group advances in lock-step), so
        memory stays O(n_groups * k) however many clusters a group holds."""
        run = BatchTopK(self.k, self.seed_dists.copy(), self.seed_ids.copy())
        kth_col = self.group_k - 1
        for j in range(g_max):
            act = np.flatnonzero(sizes > j)
            items = self.group_start[act] + j
            run.merge_rows(act, results.dists[items], results.ids[items])
            kth = run.dists[act, kth_col[act]].astype(np.float64)
            imp = kth < ref[act] - _EPS
            ref[act[imp]] = kth[imp]
            noimp[act[imp]] = 0
            noimp[act[~imp]] += 1
        return PlanResult(run.dists, run.ids, ref, noimp)


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


class PlanBuilder:
    """Accumulates (query, clusters) groups and emits a ``RetrievalPlan``."""

    def __init__(self):
        self._queries: list[np.ndarray] = []  # one (d,) vector per group
        self._clusters: list[np.ndarray] = []  # clusters probed per group
        self._k: list[int] = []
        self._meta: list[Any] = []
        self._seeds: list[Optional[TopK]] = []
        self._last_kth: list[float] = []
        self._no_improve: list[int] = []
        self._fanout: list[int] = []
        self._out_k: list[int] = []

    def __len__(self) -> int:
        return len(self._queries)

    @property
    def empty(self) -> bool:
        return not self._queries

    def add(
        self,
        query: np.ndarray,
        clusters: Sequence[int],
        *,
        k: int,
        meta: Any = None,
        seed: Optional[TopK] = None,
        last_kth: float = np.inf,
        no_improve: int = 0,
        fanout: int = 1,
        out_k: Optional[int] = None,
    ) -> int:
        """Add one group: ``query`` probing ``clusters`` with running ``seed``.

        ``out_k`` widens the *scoreboard* (``plan.k``) beyond the group's
        requested ``k`` without touching ``group_k`` — the k-th-distance
        streaks and the returned ``group_topk(g, k)`` stay identical, but
        ``finalize`` rows carry ``out_k`` candidates (used by the crossreq
        global cache to publish top-k' entries at no extra scan cost).
        """
        gid = len(self._queries)
        self._queries.append(np.asarray(query, np.float32))
        self._clusters.append(np.asarray(clusters, np.int64))
        self._k.append(int(k))
        self._meta.append(meta)
        self._seeds.append(seed)
        self._last_kth.append(float(last_kth))
        self._no_improve.append(int(no_improve))
        self._fanout.append(max(1, int(fanout)))
        self._out_k.append(int(out_k) if out_k is not None else int(k))
        return gid

    def build(self) -> RetrievalPlan:
        if not self._queries:
            raise ValueError("empty plan")
        n_groups = len(self._queries)
        counts = np.array([c.shape[0] for c in self._clusters], np.int64)
        group_start = np.zeros(n_groups + 1, np.int64)
        np.cumsum(counts, out=group_start[1:])
        cluster_ids = (
            np.concatenate(self._clusters)
            if counts.sum() else np.zeros(0, np.int64)
        )
        item_group = np.repeat(np.arange(n_groups, dtype=np.int64), counts)
        group_q = np.stack(self._queries).astype(np.float32, copy=False)
        queries = group_q[item_group]
        q_norms = (group_q**2).sum(-1)[item_group]
        group_k = np.array(self._k, np.int64)
        k = int(max(group_k.max(), max(self._out_k)))
        seed_d = np.full((n_groups, k), np.inf, np.float32)
        seed_i = np.full((n_groups, k), -1, np.int64)
        for g, tk in enumerate(self._seeds):
            if tk is not None:
                kk = min(tk.k, k)
                seed_d[g, :kk] = tk.dists[:kk]
                seed_i[g, :kk] = tk.ids[:kk]
        order = np.argsort(cluster_ids, kind="stable")
        sorted_c = cluster_ids[order]
        if sorted_c.size:
            uniq, first = np.unique(sorted_c, return_index=True)
            seg_bounds = np.append(first, sorted_c.size).astype(np.int64)
        else:
            uniq = np.zeros(0, np.int64)
            seg_bounds = np.zeros(1, np.int64)
        return RetrievalPlan(
            queries=queries,
            q_norms=q_norms,
            cluster_ids=cluster_ids,
            k=k,
            item_group=item_group,
            group_start=group_start,
            group_k=group_k,
            group_fanout=np.array(self._fanout, np.int64),
            group_meta=list(self._meta),
            seed_dists=seed_d,
            seed_ids=seed_i,
            group_last_kth=np.array(self._last_kth, np.float64),
            group_no_improve=np.array(self._no_improve, np.int64),
            seg_order=order.astype(np.int64),
            seg_cluster=uniq.astype(np.int64),
            seg_bounds=seg_bounds,
        )


# ---------------------------------------------------------------------------
# Scatter-gather (shard-mode serving): partial-scan reassembly
# ---------------------------------------------------------------------------


def make_gather_plan(
    query: np.ndarray,
    clusters: Sequence[int],
    *,
    k: int,
    seed: Optional[TopK] = None,
    last_kth: float = np.inf,
    no_improve: int = 0,
    out_k: Optional[int] = None,
) -> RetrievalPlan:
    """One-group replay plan for a scatter-gather merge.

    Shard-mode serving splits a sub-stage's probe list into per-shard
    partial scans; each partial returns *item-level* rows (one per
    (query, cluster) probe, exactly what the whole-index path would have
    computed for those items).  The gather step scatters those rows back
    into a single scoreboard ordered like the original probe list and folds
    it with this plan's ``finalize`` — the same seed/streak fold the
    whole-index path runs, so the k-way merged result (top-k, ``no_improve``
    streak, ``last_kth``) is bit-identical to a single worker scanning the
    whole probe list.
    """
    b = PlanBuilder()
    b.add(query, clusters, k=int(k), seed=seed, last_kth=last_kth,
          no_improve=no_improve, out_k=out_k)
    return b.build()


def gather_scatter_rows(
    scoreboard: BatchTopK,
    positions: np.ndarray,
    results: BatchTopK,
    start: int,
    stop: int,
) -> None:
    """Copy one partial scan's item rows ``results[start:stop]`` into the
    gather ``scoreboard`` at ``positions`` (the items' indices in the
    original probe-list order).  Rows are ascending +inf/-1 padded, so
    trimming a wider executing plan's rows to the gather width keeps
    exactly the top candidates the narrower whole-index row would hold."""
    gk = scoreboard.k
    scoreboard.dists[positions] = results.dists[start:stop, :gk]
    scoreboard.ids[positions] = results.ids[start:stop, :gk]


# ---------------------------------------------------------------------------
# Convenience: plan-based full search (reference-equivalent)
# ---------------------------------------------------------------------------


def plan_search(
    index, q: np.ndarray, nprobe: int, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Full IVF search through the plan executor.

    Semantically identical to ``IVFIndex.search`` (same probe order, same
    merge semantics); one group per query, one item per probed cluster.
    Returns ``(dists (Q, k), ids (Q, k))``.
    """
    q2 = np.atleast_2d(np.asarray(q, np.float32))
    probes = index.probe_order(q2, nprobe)
    b = PlanBuilder()
    for r in range(q2.shape[0]):
        b.add(q2[r], probes[r], k=k)
    plan = b.build()
    out = index.search_plan(plan)
    res = plan.finalize(out)
    return res.dists[:, :k].copy(), res.ids[:, :k].copy()


def plan_from_work(
    work: Sequence[tuple[np.ndarray, int, TopK]]
) -> RetrievalPlan:
    """Adapt the legacy per-item work-list protocol to a plan: one group per
    (query, cluster, running-topk) item, seeded with the running top-k."""
    b = PlanBuilder()
    for q, cid, tk in work:
        b.add(q, [int(cid)], k=tk.k, seed=tk)
    return b.build()

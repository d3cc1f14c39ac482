"""IVF (inverted-file) vector index with step-wise, cluster-granular search.

Two execution paths mirror the paper's hybrid engine:

* **host path** — numpy/BLAS search over the flat cluster-sorted store
  (stands in for multi-threaded Faiss on the CPU of a TPU host);
* **device path** — clusters packed into fixed 128-aligned tiles
  (``cluster_tensor``) consumed by the fused distance+top-k Pallas kernel
  (``repro_torch.kernels.ivf_scan``) or its plain PyTorch version.

Beyond plain search, the index exposes the primitives HedraRAG's scheduler
needs (paper §4.2/§4.3/§5):

* ``probe_order``           — nprobe nearest centroids per query;
* ``search_cluster_batch``  — variable-length (query x cluster) work items;
* ``TopK.merge``            — running-result merge across sub-stages;
* triangle-inequality lower bounds (centroid distance - cluster radius) for
  lossless early termination under similarity-aware cluster reordering.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Running top-k
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TopK:
    """Running top-k (smallest L2^2 distances) for one query."""

    k: int
    dists: np.ndarray  # (k,) float32, +inf padded
    ids: np.ndarray  # (k,) int64, -1 padded

    @classmethod
    def empty(cls, k: int) -> "TopK":
        return cls(k, np.full((k,), np.inf, np.float32), np.full((k,), -1, np.int64))

    def merge(self, dists: np.ndarray, ids: np.ndarray) -> "TopK":
        d = np.concatenate([self.dists, dists.astype(np.float32)])
        i = np.concatenate([self.ids, ids.astype(np.int64)])
        if d.shape[0] > self.k:
            sel = np.argpartition(d, self.k - 1)[: self.k]
            sel = sel[np.argsort(d[sel], kind="stable")]
        else:
            sel = np.argsort(d, kind="stable")
        return TopK(self.k, d[sel], i[sel])

    @property
    def kth(self) -> float:
        return float(self.dists[-1])

    def valid(self) -> np.ndarray:
        return self.ids >= 0


# ---------------------------------------------------------------------------
# Index
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IVFIndex:
    centroids: np.ndarray  # (K, d) f32
    flat: np.ndarray  # (N, d) f32, sorted by cluster
    flat_norms: np.ndarray  # (N,) precomputed ||v||^2
    ids: np.ndarray  # (N,) original doc id per row
    offsets: np.ndarray  # (K+1,) int64 cluster row ranges
    radii: np.ndarray  # (K,) max member distance to centroid (for pruning)
    _row_of_doc: Optional[np.ndarray] = None  # lazy doc-id -> flat-row inverse

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        n_clusters: int,
        *,
        seed: int = 0,
        iters: int = 10,
        device="cuda",
        init_idx: Optional[np.ndarray] = None,
    ) -> "IVFIndex":
        """k-means (``repro_torch.retrieval.kmeans``) on ``device``, then the
        cluster-sorted host store.  ``init_idx`` (k data indices) defaults
        to ``np.random.default_rng(seed)``'s draw."""
        import torch

        from repro_torch.device import resolve_device
        from repro_torch.retrieval.kmeans import kmeans

        v = np.asarray(vectors, np.float32)
        data = torch.from_numpy(v).to(resolve_device(device))
        cent, asn = kmeans(data, n_clusters, iters=iters, init_idx=init_idx,
                           seed=seed)
        cent = cent.cpu().numpy().astype(np.float32)
        asn = asn.cpu().numpy()
        del data
        order = np.argsort(asn, kind="stable")
        flat = v[order]
        ids = order.astype(np.int64)
        counts = np.bincount(asn, minlength=n_clusters)
        offsets = np.zeros(n_clusters + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        # cluster radii (for triangle-inequality early termination)
        diffs = flat - cent[asn[order]]
        member_d = np.linalg.norm(diffs, axis=1)
        radii = np.zeros(n_clusters, np.float32)
        np.maximum.at(radii, asn[order], member_d.astype(np.float32))
        return cls(
            centroids=cent,
            flat=flat,
            flat_norms=(flat**2).sum(-1).astype(np.float32),
            ids=ids,
            offsets=offsets,
            radii=radii,
        )

    # ------------------------------------------------------------- properties
    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    def cluster_size(self, cid: int) -> int:
        return int(self.offsets[cid + 1] - self.offsets[cid])

    def cluster_sizes(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)

    def _doc_rows(self, doc_ids) -> np.ndarray:
        if self._row_of_doc is None:
            inv = np.empty(self.ids.shape[0], np.int64)
            inv[self.ids] = np.arange(self.ids.shape[0])
            object.__setattr__(self, "_row_of_doc", inv)
        return self._row_of_doc[np.asarray(doc_ids, np.int64)]

    def doc_cluster(self, doc_ids: np.ndarray) -> np.ndarray:
        """Map original doc ids -> owning cluster ids."""
        rows = self._doc_rows(doc_ids)
        return (np.searchsorted(self.offsets, rows, side="right") - 1).astype(np.int64)

    def doc_vectors(self, doc_ids) -> np.ndarray:
        """Gather stored vectors by original doc id (rerank/compress stage
        scoring operates on retrieved candidates, not cluster layout)."""
        return self.flat[self._doc_rows(doc_ids)]

    # ----------------------------------------------------------------- search
    def centroid_dists(self, q: np.ndarray) -> np.ndarray:
        """q: (d,) or (Q, d) -> squared L2 to each centroid (Q, K)."""
        q2 = np.atleast_2d(q).astype(np.float32)
        c = self.centroids
        return (
            (q2**2).sum(-1, keepdims=True)
            - 2.0 * q2 @ c.T
            + (c**2).sum(-1)[None, :]
        )

    def probe_order(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        """nprobe nearest cluster ids, ascending centroid distance. (Q, nprobe)."""
        d = self.centroid_dists(q)
        npb = min(nprobe, self.n_clusters)
        part = np.argpartition(d, npb - 1, axis=1)[:, :npb]
        row = np.take_along_axis(d, part, axis=1)
        srt = np.argsort(row, axis=1, kind="stable")
        return np.take_along_axis(part, srt, axis=1)

    def cluster_lower_bound(self, q: np.ndarray, cids: np.ndarray) -> np.ndarray:
        """Lossless lower bound on squared distance to any member of cids."""
        cd = np.sqrt(np.maximum(self.centroid_dists(q)[0][cids], 0.0))
        lb = np.maximum(cd - self.radii[cids], 0.0)
        return lb**2

    def search_cluster(
        self, q: np.ndarray, cid: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exhaustive scan of one cluster.  q: (Q, d).  -> (dists, ids) (Q, m)."""
        lo, hi = int(self.offsets[cid]), int(self.offsets[cid + 1])
        block = self.flat[lo:hi]
        q2 = np.atleast_2d(q).astype(np.float32)
        d = (
            (q2**2).sum(-1, keepdims=True)
            - 2.0 * q2 @ block.T
            + self.flat_norms[lo:hi][None, :]
        )
        return d, np.broadcast_to(self.ids[lo:hi][None, :], d.shape)

    def search_cluster_batch(
        self, work: Sequence[tuple[np.ndarray, int, TopK]]
    ) -> list[TopK]:
        """Variable-length (query, cluster, running-topk) work items (§5).

        Groups items by cluster so each cluster block is streamed once and
        shared across all queries probing it — the cross-request batching the
        paper's extended-Faiss interface provides.
        """
        by_cluster: dict[int, list[int]] = {}
        for i, (_, cid, _) in enumerate(work):
            by_cluster.setdefault(cid, []).append(i)
        out: list[Optional[TopK]] = [None] * len(work)
        for cid, idxs in by_cluster.items():
            qs = np.stack([work[i][0] for i in idxs])
            d, ids = self.search_cluster(qs, cid)
            for row, i in enumerate(idxs):
                tk = work[i][2]
                out[i] = tk.merge(d[row], ids[row])
        return out  # type: ignore[return-value]

    # ------------------------------------------------- plan (SoA) execution
    def scan_segments(self, plan, seg_indices, out) -> None:
        """Scan the given plan segments on the host path.

        Per segment the cluster block is GEMM-scanned once against the
        stacked queries of every item probing it (minimal FLOPs — no padded
        columns).  The per-item top-k reduction is then done in *size
        buckets*: segments of similar cluster size share one padded
        candidate matrix and a single argpartition/sort, so the number of
        numpy reductions scales with the size spread, not the segment count.

        ``out`` is the plan's item-level :class:`BatchTopK` scoreboard; each
        item belongs to exactly one segment, so its row is written once
        (the rows passed here must still be in their empty state).
        """
        k = out.k
        segs = np.asarray(seg_indices, np.int64)
        if segs.size == 0:
            return
        # offsets / bucket layout vectorized over the selected segments;
        # query rows are gathered per bucket (only the selected segments'
        # items, not the whole plan)
        los = self.offsets[plan.seg_cluster[segs]]
        his = self.offsets[plan.seg_cluster[segs] + 1]
        ms = (his - los).astype(np.int64)
        sa = plan.seg_bounds[segs]
        se = plan.seg_bounds[segs + 1]
        nqs = (se - sa).astype(np.int64)
        keep = (ms > 0) & (nqs > 0)
        if not keep.all():
            los, his, ms, sa, se, nqs = (
                a[keep] for a in (los, his, ms, sa, se, nqs))
        if ms.size == 0:
            return
        # bucket key: geometric size class (1.35x steps) — finer than pow2
        # so the padded candidate width stays close to the true cluster
        # size (the top-k partition cost is linear in padded width)
        keys = np.ceil(np.log(ms) / np.log(1.35)).astype(np.int64)
        for key in np.unique(keys):
            pick = np.flatnonzero(keys == key)
            width = max(int(ms[pick].max()), k)  # tight, not the pow2 key
            n = int(nqs[pick].sum())
            cand = np.full((n, width), np.inf, np.float32)
            lo_row = np.repeat(los[pick], nqs[pick])
            m_row = np.repeat(ms[pick], nqs[pick])
            # item rows of the bucket = concat of the picked seg_order runs
            nq_pick = nqs[pick]
            flat_pos = (np.repeat(sa[pick], nq_pick) + np.arange(n)
                        - np.repeat(np.cumsum(nq_pick) - nq_pick, nq_pick))
            rows_all = plan.seg_order[flat_pos]
            q_bucket = plan.queries[rows_all]
            qn_bucket = plan.q_norms[rows_all]
            at = 0
            for i in pick:
                lo, hi, m, nr = los[i], his[i], int(ms[i]), int(nqs[i])
                # ||q||^2 - 2 q.x + ||x||^2, GEMM-ed straight into the
                # bucket matrix (bit-identical to search_cluster)
                d = cand[at: at + nr, :m]
                np.matmul(q_bucket[at: at + nr], self.flat[lo:hi].T, out=d)
                d *= -2.0
                d += qn_bucket[at: at + nr, None]
                d += self.flat_norms[lo:hi][None, :]
                at += nr
            if width > k:
                sel = np.argpartition(cand, k - 1, axis=1)[:, :k]
                cand = np.take_along_axis(cand, sel, axis=1)
            else:
                sel = np.broadcast_to(np.arange(width), cand.shape)
            order = np.argsort(cand, axis=1, kind="stable")
            sel = np.take_along_axis(sel, order, axis=1)
            # doc ids straight from the flat store (pad columns -> -1),
            # instead of materialising a full (n, width) id matrix
            valid = sel < m_row[:, None]
            flat_rows = np.minimum(lo_row[:, None] + sel, self.ids.shape[0] - 1)
            out.dists[rows_all] = np.take_along_axis(cand, order, axis=1)
            out.ids[rows_all] = np.where(valid, self.ids[flat_rows], -1)

    def search_plan(self, plan, out=None):
        """Execute a whole :class:`~repro_torch.retrieval.plan.RetrievalPlan` on
        the host path.  Returns the item-level ``BatchTopK`` scoreboard
        (callers fold it per group via ``plan.finalize``)."""
        from repro_torch.retrieval.plan import BatchTopK

        if out is None:
            out = BatchTopK.empty(plan.n_items, plan.k)
        self.scan_segments(plan, np.arange(plan.n_segments), out)
        return out

    def search(
        self, q: np.ndarray, nprobe: int, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Full reference search.  q: (Q, d) -> (dists (Q, k), ids (Q, k))."""
        q2 = np.atleast_2d(q)
        probes = self.probe_order(q2, nprobe)
        D = np.zeros((q2.shape[0], k), np.float32)
        I = np.zeros((q2.shape[0], k), np.int64)
        for r in range(q2.shape[0]):
            tk = TopK.empty(k)
            for cid in probes[r]:
                d, ids = self.search_cluster(q2[r : r + 1], int(cid))
                tk = tk.merge(d[0], ids[0])
            D[r], I[r] = tk.dists, tk.ids
        return D, I

    # ----------------------------------------------- device (tile) packing
    def cluster_tensor(
        self, cids: Sequence[int], pad_to: int = 128
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pack clusters into fixed tiles for the device path.

        Returns (slab (n, L, d) f32 zero-padded, valid (n,) int32,
        slab_ids (n, L) int64 with -1 padding), where L = max size rounded up
        to ``pad_to`` (MXU lane alignment).
        """
        sizes = [self.cluster_size(int(c)) for c in cids]
        L = max(pad_to, -(-max(sizes + [1]) // pad_to) * pad_to)
        n = len(cids)
        slab = np.zeros((n, L, self.dim), np.float32)
        slab_ids = np.full((n, L), -1, np.int64)
        valid = np.zeros((n,), np.int32)
        for j, cid in enumerate(cids):
            lo, hi = int(self.offsets[cid]), int(self.offsets[cid + 1])
            m = hi - lo
            slab[j, :m] = self.flat[lo:hi]
            slab_ids[j, :m] = self.ids[lo:hi]
            valid[j] = m
        return slab, valid, slab_ids


# ---------------------------------------------------------------------------
# Cost model (used by the discrete-event executor; calibrated at runtime)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClusterCostModel:
    """t(cluster) = fixed + per_vector * size (+ per_query amortised).

    ``calibrate`` measures real host search times and fits the linear model —
    the same measured distribution drives Fig. 6(b)-style variation.
    """

    fixed_us: float = 20.0
    per_vector_us: float = 0.05
    per_query_us: float = 2.0

    def cost_us(self, size: int, n_queries: int = 1) -> float:
        return self.fixed_us + self.per_vector_us * size + self.per_query_us * n_queries

    def cost_vec_us(self, sizes: np.ndarray, n_queries: np.ndarray) -> np.ndarray:
        """Per-cluster cost over a segment table: element-wise
        ``fixed + per_vector * size + per_query * n_queries``."""
        sizes = np.asarray(sizes, np.float64)
        nq = np.asarray(n_queries, np.float64)
        return self.fixed_us + self.per_vector_us * sizes + self.per_query_us * nq

    def batch_cost_us(self, sizes: np.ndarray, n_queries: int = 1) -> float:
        """Vectorized sum of cost_us over many clusters (one query each)."""
        sizes = np.asarray(sizes, np.float64)
        return float(
            sizes.size * (self.fixed_us + self.per_query_us * n_queries)
            + self.per_vector_us * sizes.sum()
        )

    @classmethod
    def calibrate(cls, index: IVFIndex, n_samples: int = 32, seed: int = 0) -> "ClusterCostModel":
        import time

        rng = np.random.default_rng(seed)
        sizes, times = [], []
        cids = rng.choice(index.n_clusters, size=min(n_samples, index.n_clusters), replace=False)
        q = rng.standard_normal((1, index.dim)).astype(np.float32)
        for cid in cids:
            t0 = time.perf_counter()
            index.search_cluster(q, int(cid))
            dt = (time.perf_counter() - t0) * 1e6
            sizes.append(index.cluster_size(int(cid)))
            times.append(dt)
        sizes_a = np.array(sizes, np.float64)
        times_a = np.array(times, np.float64)
        if len(sizes) >= 2 and sizes_a.std() > 0:
            slope, intercept = np.polyfit(sizes_a, times_a, 1)
            slope = max(slope, 1e-4)
            intercept = max(intercept, 1.0)
        else:
            slope, intercept = 0.05, 20.0
        return cls(fixed_us=float(intercept), per_vector_us=float(slope))

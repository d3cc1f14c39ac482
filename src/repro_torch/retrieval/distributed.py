"""Distributed IVF search: clusters sharded across ranks (torch.distributed).

The pod-scale layout for the retrieval side of HedraRAG: the cluster slab is
split into contiguous tile ranges, one per rank of a process group (rank
``i`` owns tiles ``[i * C/world, (i+1) * C/world)``), queries are
replicated, every rank computes a *local* distance + top-k over its tiles,
and the (Q, k) candidate lists are all-gathered and k-way merged by the
``topk_merge`` kernel -- the classic distributed-ANN reduction.  On a host
with one card per rank the group is NCCL; the tests run it with gloo on CPU
processes.

Wire cost per query: world * k * 12 bytes (dist + id) -- negligible next to
the O(C * L * d / world) local scans, which is why cluster sharding scales
linearly until the merge latency floor (~2 * link latency).

``ShardMap`` and ``scatter_gather_search`` (the serving path's numpy side)
are copies of the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.topk_merge import topk_merge


# ---------------------------------------------------------------------------
# Cluster -> shard ownership (the serving-path side of distribution)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardMap:
    """Cluster-ownership table for shard-mode serving.

    Each retrieval worker owns one shard of the IVF cluster table; in the
    canonical layout (``build``) shards are *contiguous cluster ranges*
    balanced by vector mass, mirroring how ``make_sharded_search`` splits
    the device slab over the mesh ``data`` axis (chip ``i`` owns tile range
    ``[bounds[i], bounds[i+1])``).  ``from_owner`` accepts an arbitrary
    cluster->shard assignment (property tests, externally planned layouts).

    The scheduler uses ``split`` to scatter a sub-stage's probe list into
    per-shard partial scans and the dispatcher uses ``owner``/``bounds`` for
    placement; hot clusters may additionally be served by crossreq replica
    holders (see ``RetrievalDispatcher.pick_shard_worker``).
    """

    owner: np.ndarray  # (n_clusters,) i64 owning shard per cluster
    bounds: Optional[np.ndarray] = None  # (n_shards+1,) for contiguous maps
    n_shards: int = 0

    def __post_init__(self):
        self.owner = np.asarray(self.owner, np.int64)
        if self.n_shards <= 0:
            self.n_shards = int(self.owner.max()) + 1 if self.owner.size else 1

    @property
    def n_clusters(self) -> int:
        return int(self.owner.shape[0])

    @classmethod
    def build(cls, cluster_sizes: Sequence[int], n_shards: int) -> "ShardMap":
        """Contiguous cluster-range shards balanced by vector mass: shard
        boundaries are placed on the size prefix sum so each worker scans
        ~1/N of the corpus, not 1/N of the (skew-sized) clusters."""
        sizes = np.asarray(cluster_sizes, np.float64)
        n_shards = max(1, int(n_shards))
        n_clusters = sizes.shape[0]
        if n_shards >= n_clusters:
            owner = np.arange(n_clusters, dtype=np.int64)
            bounds = np.arange(n_clusters + 1, dtype=np.int64)
            return cls(owner=owner, bounds=bounds, n_shards=max(n_clusters, 1))
        prefix = np.cumsum(sizes)
        total = prefix[-1] if prefix.size else 0.0
        cuts = [0]
        for j in range(1, n_shards):
            c = int(np.searchsorted(prefix, j * total / n_shards,
                                    side="right"))
            cuts.append(min(max(c, cuts[-1] + 1), n_clusters - (n_shards - j)))
        cuts.append(n_clusters)
        bounds = np.asarray(cuts, np.int64)
        owner = np.zeros(n_clusters, np.int64)
        for s in range(n_shards):
            owner[bounds[s]: bounds[s + 1]] = s
        return cls(owner=owner, bounds=bounds, n_shards=n_shards)

    @classmethod
    def from_owner(cls, owner: Sequence[int],
                   n_shards: Optional[int] = None) -> "ShardMap":
        """Arbitrary (not necessarily contiguous) cluster->shard assignment."""
        arr = np.asarray(owner, np.int64)
        return cls(owner=arr,
                   n_shards=int(n_shards) if n_shards else 0)

    def owner_of(self, clusters: Iterable[int]) -> np.ndarray:
        return self.owner[np.asarray(list(clusters), np.int64)]

    def split(self, clusters: Sequence[int]) -> list[tuple[int, list[int]]]:
        """Scatter a probe list by owning shard: ``[(shard, [cid, ...]),
        ...]`` ascending by shard id, order of clusters preserved within
        each part.  Empty shards are omitted."""
        cl = list(clusters)
        if not cl:
            return []
        own = self.owner[np.asarray(cl, np.int64)]
        parts: dict[int, list[int]] = {}
        for cid, o in zip(cl, own):
            parts.setdefault(int(o), []).append(int(cid))
        return sorted(parts.items())

    def shard_sizes(self, cluster_sizes: Sequence[int]) -> np.ndarray:
        """Vector mass per shard (diagnostics / balance reporting)."""
        sizes = np.asarray(cluster_sizes, np.float64)
        return np.bincount(self.owner, weights=sizes,
                           minlength=self.n_shards)


def _local_scan_topk(q: torch.Tensor, slab: torch.Tensor, valid: torch.Tensor,
                     base_row: int, k: int):
    """Scan all local cluster tiles for all queries.

    q: (Q, d); slab: (Cl, L, d); valid: (Cl,); base_row: global index of
    this shard's first tile.  Returns (dists (Q, k) f32, rows (Q, k) i64)
    where rows are *global* (tile, row) flat indices.  Columns at or past a
    tile's ``valid`` are +inf; the selection is a stable sort, so on ties
    the lower column wins, as ``lax.top_k`` does.
    """
    Q, d = q.shape
    Cl, L, _ = slab.shape
    flat = slab.reshape(Cl * L, d).float()
    qf = q.float()
    d2 = (
        (qf ** 2).sum(-1, keepdim=True)
        - 2.0 * qf @ flat.T
        + (flat ** 2).sum(-1)[None, :]
    )  # (Q, Cl*L)
    col = torch.arange(Cl * L, device=slab.device)
    mask = (col % L)[None, :] < valid.long()[col // L][None, :]
    d2 = torch.where(mask, d2, torch.inf)
    dists, idx = torch.sort(d2, dim=1, stable=True)
    return dists[:, :k], idx[:, :k] + base_row * L


def make_sharded_search(k: int, group=None):
    """Build the sharded search of a process group whose rank ``i`` holds
    the ``i``-th of ``world`` equal contiguous tile ranges of the slab.

    Signature: f(queries (Q, d), slab_local (C/world, L, d), valid_local
    (C/world,)) -> (dists (Q, k), global_rows (Q, k)), the same on every
    rank.  Each rank scans its tiles, the (Q, k) lists are all-gathered over
    ``group`` (the default group when None) and merged by ``topk_merge``:
    shard 0's list is the running top-k and shards 1..world-1, flattened in
    shard order, are the candidates, so ties go to the lower shard as in
    ``lax.top_k`` over the gathered lists.  With a world of 1 the local
    result is returned as it is.  The lists cross the group on the scan's
    device: NCCL takes CUDA tensors directly, gloo passes them through the
    host.
    """

    def search(q: torch.Tensor, slab: torch.Tensor, valid: torch.Tensor):
        world = dist.get_world_size(group)
        base = dist.get_rank(group) * slab.shape[0]
        d_loc, r_loc = _local_scan_topk(q, slab, valid, base, k)
        if world == 1:
            return d_loc, r_loc
        lists = []
        for t in (d_loc, r_loc):
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t, group=group)
            lists.append(parts)
        (run_d, *cand_d), (run_i, *cand_i) = lists
        return topk_merge(run_d, run_i, torch.cat(cand_d, dim=1), torch.cat(cand_i, dim=1))

    return search


def reference_search(q, slab, valid, k):
    """Single-device oracle over the full slab (for tests)."""
    return _local_scan_topk(q, slab, valid, 0, k)


def scatter_gather_search(
    index, q: np.ndarray, nprobe: int, k: int, shard_map: ShardMap,
    shards=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Whole-index IVF search through the serving scatter-gather path.

    The probe list of each query is split by owning shard
    (``ShardMap.split``), each part is scanned as an independent partial
    plan (what a shard worker executes), the partial item rows are scattered
    back into one gather scoreboard in original probe order, and the gather
    plan's ``finalize`` performs the k-way merge.  Bit-identical to
    ``plan_search``/``IVFIndex.search`` — the serving-path analogue of
    ``make_sharded_search``'s all-gather + top-k reduction, on the host.
    Returns ``(dists (Q, k), ids (Q, k))``.

    ``shards`` restricts the scan to a subset of surviving shard ids (the
    degraded-mode oracle after worker crashes): probes owned by missing
    shards are dropped before planning, so the result is the partial top-k a
    degraded-complete request observes — and, for the surviving shards, the
    parity guarantee versus the whole-index fold over that reduced probe
    list is unchanged.
    """
    from repro_torch.retrieval.plan import (
        BatchTopK, PlanBuilder, gather_scatter_rows, make_gather_plan,
    )

    q2 = np.atleast_2d(np.asarray(q, np.float32))
    probes = index.probe_order(q2, nprobe)
    Q = q2.shape[0]
    clusters = [[int(c) for c in probes[r]] for r in range(Q)]
    if shards is not None:
        alive = {int(s) for s in shards}
        clusters = [[c for c in cl if int(shard_map.owner[c]) in alive]
                    for cl in clusters]
    owners = [shard_map.owner_of(cl) for cl in clusters]
    gathers = [make_gather_plan(q2[r], clusters[r], k=k) for r in range(Q)]
    boards = [BatchTopK.empty(len(clusters[r]), gathers[r].k)
              for r in range(Q)]
    # one partial plan per shard, spanning *all* queries probing it — a
    # cluster belongs to exactly one shard, so each cluster block is scanned
    # against exactly the query set the whole-index plan would batch it with
    # (same segment table, same GEMM shapes, bit-identical item rows)
    for shard in range(shard_map.n_shards):
        pb = PlanBuilder()
        members = []  # (query, positions into its board)
        for r in range(Q):
            pos = np.flatnonzero(owners[r] == shard)
            if pos.size == 0:
                continue
            pb.add(q2[r], [clusters[r][int(p)] for p in pos], k=k)
            members.append((r, pos))
        if pb.empty:
            continue
        partial = pb.build()
        rows = index.search_plan(partial)
        for g, (r, pos) in enumerate(members):
            gather_scatter_rows(boards[r], pos, rows,
                                int(partial.group_start[g]),
                                int(partial.group_start[g + 1]))
    D = np.zeros((Q, k), np.float32)
    I = np.zeros((Q, k), np.int64)
    for r in range(Q):
        res = gathers[r].finalize(boards[r])
        D[r], I[r] = res.dists[0, :k], res.ids[0, :k]
    return D, I


"""The exact scan over probed clusters, in float64 on the host.

An item is one (query, cluster) pair of a retrieval sub-stage: its answer
is the k nearest members of that cluster by squared L2 distance.  The
members are read from the benchmark's own corpus by doc id; which docs make
up a cluster is the program's partition (its state), checked on its own by
``partition_problems``.
"""
from __future__ import annotations

import numpy as np


def partition_problems(ids: np.ndarray, offsets: np.ndarray, n_docs: int) -> list:
    """What is wrong with a partition of doc ids 0 .. n_docs - 1 into
    clusters (``ids`` cluster-sorted, cluster c at ``ids[offsets[c]:
    offsets[c + 1]]``); empty when every doc is in exactly one cluster."""
    out = []
    if offsets[0] != 0 or offsets[-1] != len(ids) or np.any(np.diff(offsets) < 0):
        out.append("offsets do not cover the rows in order")
    if len(ids) != n_docs or not np.array_equal(np.sort(ids), np.arange(n_docs)):
        out.append(f"the rows are not each doc once ({len(ids)} rows, {n_docs} docs)")
    return out


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (to nearest even) and widened back to f32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.view(np.float32)


def scan_topk(query: np.ndarray, members: np.ndarray, vectors: np.ndarray, k: int,
              precision: str = "f64"):
    """(ids, dists) of the ``k`` members nearest ``query``, nearest first,
    ties to the lower doc id.  ``f64``: the reference, float64 throughout;
    ``bf16``: the control, the query and rows rounded to bfloat16 and the
    distances taken in f32."""
    if precision == "f64":
        q, v = query.astype(np.float64), vectors.astype(np.float64)
    elif precision == "bf16":
        q, v = _bf16(query), _bf16(vectors)
    else:
        raise ValueError(precision)
    d = ((v - q) ** 2).sum(-1)
    order = np.lexsort((members, d))[:k]
    return members[order], d[order]


def true_dists(query: np.ndarray, vectors: np.ndarray) -> np.ndarray:
    q = query.astype(np.float64)
    return ((vectors.astype(np.float64) - q) ** 2).sum(-1)

"""Lloyd k-means in PyTorch (IVF training), on the device of its data.

Chunked assignment keeps the (N, K) distance matrix out of memory.  The
init indices are explicit: the JAX version draws them with
``jax.random.choice``, which torch cannot reproduce, so callers that need
parity pass the JAX draw as ``init_idx``; by default they come from
``np.random.default_rng(seed)``.
"""
from __future__ import annotations

import numpy as np
import torch


def assign_clusters(data: torch.Tensor, centroids: torch.Tensor, chunk: int = 8192):
    """Returns (assignment (N,) int64, min_dist (N,) f32) via chunked L2 argmin.

    Ties go to the lowest centroid index (``torch.argmin`` returns the first
    minimum, as ``jnp.argmin`` does).
    """
    N = data.shape[0]
    cent = centroids.float()
    c_sq = (cent**2).sum(-1)
    asn = torch.empty((N,), dtype=torch.int64, device=data.device)
    dist = torch.empty((N,), dtype=torch.float32, device=data.device)
    for lo in range(0, N, chunk):
        x = data[lo: lo + chunk].float()
        d2 = (x**2).sum(-1, keepdim=True) - 2.0 * x @ cent.T + c_sq
        m, a = torch.min(d2, dim=-1)
        asn[lo: lo + chunk] = a
        dist[lo: lo + chunk] = m
    return asn, dist


def init_indices(n: int, k: int, seed: int = 0) -> np.ndarray:
    """k distinct data indices drawn from ``np.random.default_rng(seed)``."""
    return np.random.default_rng(seed).choice(n, size=k, replace=False)


def kmeans(data: torch.Tensor, k: int, iters: int = 10, chunk: int = 8192, *,
           init_idx=None, seed: int = 0):
    """Lloyd iterations; dead centroids re-seeded from data points.

    Returns (centroids (k, d) f32, assignment (N,) int64).  The reseed rule
    is the JAX version's: empty cluster c of iteration i takes
    ``data[(init_idx[c] + i) % N]``.  On CUDA the per-cluster sums use
    atomics (``index_add_``), so their order, and the last bits of the
    centroids, may change from run to run.
    """
    N = data.shape[0]
    if init_idx is None:
        init_idx = init_indices(N, k, seed)
    idx = torch.as_tensor(np.array(init_idx, np.int64), device=data.device)
    if idx.shape != (k,):
        raise ValueError(f"init_idx must hold k={k} indices, got shape {tuple(idx.shape)}")
    cent = data[idx].float()
    ones = torch.ones((N,), dtype=torch.float32, device=data.device)
    for i in range(iters):
        asn, _ = assign_clusters(data, cent, chunk=chunk)
        sums = torch.zeros((k, data.shape[1]), dtype=torch.float32, device=data.device)
        sums.index_add_(0, asn, data.float())
        cnts = torch.zeros((k,), dtype=torch.float32, device=data.device)
        cnts.index_add_(0, asn, ones)
        new = sums / torch.clamp(cnts, min=1.0)[:, None]
        reseed = data[(idx + i) % N].float()
        cent = torch.where((cnts > 0)[:, None], new, reseed)
    asn, _ = assign_clusters(data, cent, chunk=chunk)
    return cent, asn

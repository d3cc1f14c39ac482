"""Plain PyTorch version of the fused IVF distance + top-k kernel."""
from __future__ import annotations

import torch


def ivf_scan_ref(
    q_groups: torch.Tensor,       # (G, QB, d) query blocks (host pre-gathered)
    group_cluster: torch.Tensor,  # (G,) int32 cluster id per group
    slab: torch.Tensor,           # (C, L, d) padded cluster tiles
    valid: torch.Tensor,          # (C,) int32 valid rows per cluster
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (dists (G, QB, k) f32 ascending, idx (G, QB, k) i32 row-in-cluster).

    Squared L2 distances ``||q||^2 - 2 q.t + ||t||^2``; rows at or past
    ``valid`` are masked to +inf, and a selected +inf gets idx -1.  The sort
    is stable, so on ties the lower row wins (as ``lax.top_k`` does).
    """
    gc = group_cluster.long()
    blocks = slab[gc].float()                      # (G, L, d)
    nvalid = valid[gc]                             # (G,)
    qf = q_groups.float()
    d2 = (
        (qf**2).sum(-1)[..., None]
        - 2.0 * torch.einsum("gqd,gld->gql", qf, blocks)
        + (blocks**2).sum(-1)[:, None, :]
    )                                              # (G, QB, L)
    L = slab.shape[1]
    mask = torch.arange(L, device=slab.device)[None, None, :] < nvalid[:, None, None]
    d2 = torch.where(mask, d2, torch.inf)
    dists, idx = torch.sort(d2, dim=-1, stable=True)
    dists, idx = dists[..., :k], idx[..., :k]
    idx = torch.where(torch.isfinite(dists), idx, -1).to(torch.int32)
    return dists.float(), idx


def topk_agreement(ref_d, ref_i, ref_next, out_d, out_i, *, rtol: float, atol: float):
    """Hold a kernel's top-k (``out_*``) against the plain version's (``ref_*``).

    Ids must match exactly, except where two rows' distances are within the
    tolerance of each other, so that summation order may swap them: a
    mismatch at position j is a tie when the plain version's distance there
    is within tolerance of its neighbour at j-1 or j+1, the (k+1)-th
    (``ref_next``, +inf when there is none) included.  All arguments are
    CPU tensors of shape (..., k), ``ref_next`` of shape (...).

    Returns ``(max_abs_err, n_tie_rows, n_bad_rows)``; the distances must
    agree within ``atol + rtol * |ref|`` wherever the plain one is finite.
    """
    k = ref_d.shape[-1]
    rd, od = ref_d.reshape(-1, k).double(), out_d.reshape(-1, k).double()
    ri, oi = ref_i.reshape(-1, k), out_i.reshape(-1, k)
    fin = torch.isfinite(rd)
    if not torch.equal(fin, torch.isfinite(od)):
        return float("inf"), 0, int((fin != torch.isfinite(od)).any(-1).sum())
    err = (rd - od).abs().where(fin, torch.zeros_like(rd))
    max_err = float(err.max()) if err.numel() else 0.0
    bad_d = (err > atol + rtol * rd.abs().where(fin, torch.zeros_like(rd))).any(-1)
    ext = torch.cat([rd, ref_next.reshape(-1, 1).double()], dim=1)      # (n, k+1)
    tol = atol + rtol * ext.abs().nan_to_num(posinf=0.0)
    gap = (ext[:, 1:] - ext[:, :-1]).abs()                               # (n, k)
    near_next = gap <= tol[:, :-1]
    near_prev = torch.cat([torch.zeros_like(near_next[:, :1]), near_next[:, :-1]], dim=1)
    differ = ri != oi
    tie_ok = (~differ | near_next | near_prev).all(-1)
    rows_differ = differ.any(-1)
    n_ties = int((rows_differ & tie_ok & ~bad_d).sum())
    n_bad = int(((rows_differ & ~tie_ok) | bad_d).sum())
    return max_err, n_ties, n_bad

"""Plain PyTorch version of the running top-k merge kernel."""
from __future__ import annotations

import torch


def topk_merge_ref(
    run_d: torch.Tensor,   # (Q, k) running top-k distances, ascending
    run_i: torch.Tensor,   # (Q, k) their ids, int32 or int64
    cand_d: torch.Tensor,  # (Q, m) new candidate distances
    cand_i: torch.Tensor,  # (Q, m) their ids
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (dists (Q, k) f32 ascending, ids (Q, k) of ``run_i``'s dtype).

    The semantics of the TPU kernel's body (``_merge_kernel``): every
    non-finite distance (-inf and NaN included) counts as +inf and sorts
    last, and on ties the lower position in ``concat([run, cand])`` wins, so
    the running entries win over the candidates.  A selected non-finite slot
    comes out as ``(+inf, id)`` with the id of the non-finite entries taken
    in position order (what a stable sort gives; not -1).
    """
    k = run_d.shape[1]
    d = torch.cat([run_d.float(), cand_d.float()], dim=1)
    i = torch.cat([run_i, cand_i.to(run_i.dtype)], dim=1)
    d = torch.where(torch.isfinite(d), d, torch.inf)
    dists, sel = torch.sort(d, dim=1, stable=True)
    return dists[:, :k], torch.gather(i, 1, sel[:, :k])

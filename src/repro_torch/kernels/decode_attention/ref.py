"""Plain PyTorch version of the GQA decode-attention kernel."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(
    q: torch.Tensor,        # (B, H, dh) one new token per sequence
    k_cache: torch.Tensor,  # (B, S, KV, dh)
    v_cache: torch.Tensor,  # (B, S, KV, dh)
    lengths: torch.Tensor,  # (B,) valid cache length per sequence, >= 1
) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v over the valid prefix, in f32.  -> (B, H, dh)
    in q's dtype."""
    B, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) / math.sqrt(dh)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, dh).to(q.dtype)

"""Plain PyTorch version of the fused qk_rope kernel: the port's chain of
per-head qk-norm, split-half RoPE and the decode cache write (the JAX
package's ``models/layers.py`` ``rms_norm_headwise``, ``apply_rope`` and
``_scatter_time``, op for op).

Tolerance of the kernel against it, on the card: RoPE and the cache writes
equal bit for bit (the kernel takes the same f32 frequency table from
``rope_frequencies`` on the same device, and rounds and orders every f32
operation as this chain does, with the same cosf / sinf); the qk-norm
within 1 ulp of the model dtype (bf16) or rtol 1e-6 (f32), since the
kernel sums a head in another order than ATen's reduction.  A qk-norm
output one ulp apart can move a rotated value by more than an ulp where
the rotation cancels, so the kernel's qk-norm + RoPE is held against
``apply_rope_ref`` of the kernel's own qk-norm output, bit for bit.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def rms_norm_headwise_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (Qwen3); eps is fixed at 1e-6 as in the JAX package."""
    xf = x.float()
    y = xf * torch.rsqrt((xf**2).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope_frequencies(d: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=f32, device=device) / d))


def apply_rope_ref(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, d); positions: (..., S).  Split-half convention: the
    first and second halves of d are the rotated pairs (not interleaved)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)             # (d/2,)
    angles = positions[..., :, None].float() * freqs         # (..., S, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def scatter_time_ref(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Write new (B, 1, ...) at row ``slot[b]`` of cache (B, rows, ...), IN
    PLACE; a row past the end is clamped to the last, as
    ``lax.dynamic_update_slice`` clamps.  Returns the cache."""
    B, S = cache.shape[:2]
    pos = slot.long().clamp(0, S - 1)
    cache[torch.arange(B, device=cache.device), pos] = new[:, 0].to(cache.dtype)
    return cache


def qk_rope_ref(q: torch.Tensor, k: torch.Tensor, positions=None, *, theta=None, q_scale=None,
                k_scale=None, eps: float = 1e-6, v=None, k_cache=None, v_cache=None, slot=None):
    """q (B, S, H, dh), k (B, S, KV, dh) -> (q, k) after the qk-norm (given
    ``q_scale`` and ``k_scale``) and RoPE at ``positions`` (B, S) (given
    ``theta``); with caches (decode, S = 1) k and v are then written at row
    ``slot[b]`` of ``k_cache`` and ``v_cache`` in place."""
    if q_scale is not None:
        q = rms_norm_headwise_ref(q, q_scale, eps)
        k = rms_norm_headwise_ref(k, k_scale, eps)
    if theta is not None:
        q = apply_rope_ref(q, positions, theta)
        k = apply_rope_ref(k, positions, theta)
    if k_cache is not None:
        scatter_time_ref(k_cache, k, slot)
        scatter_time_ref(v_cache, v, slot)
    return q, k

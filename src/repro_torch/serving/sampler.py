"""Token sampling: greedy / temperature / top-k."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0  # 0 -> full softmax


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplerConfig) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32.

    Greedy is ``argmax``, ties going to the first index as in JAX.  With a
    temperature the draw comes from ``generator``; it makes no claim of
    matching ``jax.random.categorical`` bit for bit.
    """
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(scaled, cfg.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

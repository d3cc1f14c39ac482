"""Plain PyTorch version of the fused glu kernel: the port's gated
activation ``act(a) * b`` (SwiGLU's ``silu``, GeGLU's tanh-form ``gelu``),
as the JAX package's ``models/layers.py`` ``apply_ffn`` and ``apply_moe``
write it.

Tolerance of the kernel against it, on the card: equal bit for bit.  The
kernel computes each activation by ATen's own CUDA formula with the same
rounding (the activation rounded to the dtype before the product, the
product one f32 multiply rounded once), with expf / tanhf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

KINDS = ("silu", "gelu")


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def glu_ref(a: torch.Tensor, b: torch.Tensor, *, kind: str = "silu") -> torch.Tensor:
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    return (gelu(a) if kind == "gelu" else F.silu(a)) * b

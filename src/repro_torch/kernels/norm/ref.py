"""Plain PyTorch version of the fused norm kernel: the port's norm chain
(the JAX package's ``models/layers.py`` ``apply_norm`` and
``rms_norm_headwise``, op for op).

Tolerance of the kernel against it, on the card: the residual sum ``x +
delta`` equal bit for bit (one f32 add, rounded as here); the normed output
within 1 ulp of the output dtype on every element in bf16, and within rtol
1e-6 (atol 1e-6) in f32.  The kernel rounds at every place this chain does
and keeps each product and sum a separate f32 operation, but it sums a row
in another order than ATen's reduction, so the mean, and through it every
output, may differ in the last f32 bits; in bf16 that moves an output at
most one step.  Outputs near 0 that are differences of nearly equal terms
(LayerNorm's x minus the row's mean, a bias that cancels the scaled value)
carry an error of a few f32 ulps of those O(1) terms: the f32 atol covers
it, and in bf16 such a LayerNorm output is held to 2^-16 absolute, since
one ulp of its own small magnitude is finer.
"""
from __future__ import annotations

import torch

KINDS = ("rmsnorm", "layernorm")


def norm_ref(x: torch.Tensor, scale: torch.Tensor, bias=None, *, kind: str = "rmsnorm",
             eps: float, delta=None):
    """RMSNorm or LayerNorm of ``x + delta`` (or of x) over the last dim in
    f32, ``* scale`` (``+ bias``) widened from the parameters' dtype, cast to
    x's dtype.  Returns y, or (x + delta, y) when ``delta`` is given."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    if delta is not None:
        x = x + delta
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = (y * scale.float() + bias.float()).to(x.dtype)
    else:
        var = (xf**2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        y = (y * scale.float()).to(x.dtype)
    return y if delta is None else (x, y)

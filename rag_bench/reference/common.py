"""Arithmetic shared by the model references: f32 matmuls (or a lower
precision for the control), RMSNorm, split-half RoPE, causal attention."""
from __future__ import annotations

import math

import torch

F32 = torch.float32
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def no_tf32() -> None:
    """A float32 matmul on the card may otherwise run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3, scaled along ``dim`` so that its largest
    magnitude maps to 448 (per-row for activations, per-column for
    weights), and back to f32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


class Precision:
    """How the reference multiplies: ``"f32"`` (the reference), ``"fp8"``
    (the control: every matmul's operands rounded to float8 e4m3 first, the
    step below the configuration's bfloat16) or ``"bf16"`` (operands rounded
    to bfloat16: what rounding at the configuration's own precision does to
    the same forward, a witness for reading the program's gaps)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8", "bf16"):
            raise ValueError(kind)
        self.kind = kind

    def _round(self, a: torch.Tensor, b: torch.Tensor):
        if self.kind == "fp8":
            return _fp8(a, -1), _fp8(b, -2)
        if self.kind == "bf16":
            return a.to(torch.bfloat16).to(F32), b.to(torch.bfloat16).to(F32)
        return a, b

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., n) @ b (n, m) in f32, operands first rounded in fp8 mode."""
        a, b = self._round(a.to(F32), b.to(F32))
        return a @ b

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Batched a (..., n, k) @ b (..., k, m) (attention's products)."""
        a, b = self._round(a.to(F32), b.to(F32))
        return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, d), positions (S,): rotate_half RoPE (HF ``Qwen3`` and, with
    the rope dims in rotate-half order, ``DeepseekV2``)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32, device=x.device) / d))
    ang = positions.to(F32)[:, None] * inv  # (S, d/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, prec: Precision, block: int = 512) -> torch.Tensor:
    """q (S, H, dq), k (S, KV, dq), v (S, KV, dv); H a multiple of KV (GQA:
    query head h reads kv head h // (H / KV)).  Softmax over the keys at or
    before each query, scale 1 / sqrt(dq).  Returns (S, H, dv) f32."""
    S, H, dq = q.shape
    KV = k.shape[1]
    g = H // KV
    kh = k.to(F32).repeat_interleave(g, dim=1).transpose(0, 1)  # (H, S, dq)
    vh = v.to(F32).repeat_interleave(g, dim=1).transpose(0, 1)  # (H, S, dv)
    qh = q.to(F32).transpose(0, 1)  # (H, S, dq)
    scale = 1.0 / math.sqrt(dq)
    out = []
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        s = prec.bmm(qh[:, lo:hi], kh[:, :hi].transpose(1, 2)) * scale  # (H, b, hi)
        keys = torch.arange(hi, device=q.device)
        mask = keys[None, :] <= torch.arange(lo, hi, device=q.device)[:, None]
        s = torch.where(mask[None], s, -torch.inf)
        out.append(prec.bmm(torch.softmax(s, dim=-1), vh[:, :hi]))
    return torch.cat(out, dim=1).transpose(0, 1)  # (S, H, dv)


def swiglu(x, w1, w3, w2, prec: Precision) -> torch.Tensor:
    a, b = prec.mm(x, w1), prec.mm(x, w3)
    return prec.mm(torch.nn.functional.silu(a) * b, w2)

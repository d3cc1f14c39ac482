"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Block:  x -> [W_in1 -> causal conv1d -> RG-LRU]  *  gelu(W_in2 x)  -> W_out
RG-LRU: r_t = sigma(W_a c_t + b_a),  i_t = sigma(W_x c_t + b_x)
        a_t = exp(-c * softplus(lambda) * r_t)           (c = 8)
        h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * c_t)

Prefill solves the linear recurrence with a log-step (Hillis-Steele) scan:
ceil(log2 S) rounds of elementwise products over the whole sequence,
in f32.  The JAX package uses ``lax.associative_scan``, the same combine
in another tree order, so the two agree to f32 rounding.  Decode is the
O(1) elementwise update.  The conv is width-4 causal depthwise, a sum of
shifted slices.

State layout (decode): {"h": (B, W) f32, "conv": (B, cw-1, W)}
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.distributed.act_sharding import constrain
from repro_torch.models.layers import STATELESS, Init, check_mode, dtype_of, gelu

f32 = torch.float32
_C = 8.0


def init_rglru(cfg: ModelConfig, seg: Segment, mk: Init) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "w_in1": mk.normal((d, w)),
        "w_in2": mk.normal((d, w)),
        "w_out": mk.normal((w, d)),
        "conv_w": mk.normal((cfg.conv_width, w), scale=0.3),
        "conv_b": mk.full((w,), 0.0),
        "w_a": mk.normal((w, w)),
        "b_a": mk.full((w,), 0.0, dtype=f32),
        "w_x": mk.normal((w, w)),
        "b_x": mk.full((w,), 0.0, dtype=f32),
        # softplus(lam) ~ U(...) so that a^c in [0.9, 0.999] at r=1 (paper init)
        "lam": mk.uniform((w,), 0.9, 1.1, dtype=f32),
    }


def _causal_conv(p: dict, x: torch.Tensor, tail: torch.Tensor | None = None):
    """x: (B, S, W).  tail: (B, cw-1, W) previous inputs for decode."""
    cw = p["conv_w"].shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    S = x.shape[1]
    return sum(xp[:, j:j + S] * p["conv_w"][j] for j in range(cw)) + p["conv_b"]


def rglru_init_state(cfg: ModelConfig, batch: int, device=None):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=f32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype_of(cfg), device=device)}


def _gates(p: dict, c: torch.Tensor):
    cf = c.float()
    r = torch.sigmoid(cf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(cf @ p["w_x"].float() + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * cf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, by doubling:
    after the round with offset o, (a_t, b_t) holds the composition of the
    2o steps ending at t."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def apply_rglru(cfg: ModelConfig, seg: Segment, p: dict, x: torch.Tensor, *, mode: str,
                state=None, **_unused):
    check_mode(mode)
    branch = constrain(x @ p["w_in1"], "dp", None, "tp")
    gate = constrain(gelu(x @ p["w_in2"]), "dp", None, "tp")

    if mode != "decode":
        a, b = _gates(p, _causal_conv(p, branch))
        h = linear_scan(a, b)
        out = (h.to(x.dtype) * gate) @ p["w_out"]
        if mode in STATELESS:
            return out, None
        cw = cfg.conv_width
        tail = branch[:, -(cw - 1):, :]
        tail = F.pad(tail, (0, 0, (cw - 1) - tail.shape[1], 0))
        return out, {"h": h[:, -1].float(), "conv": tail}

    # decode (S == 1)
    tail = state["conv"]
    a, b = _gates(p, _causal_conv(p, branch, tail=tail))
    h = a[:, 0] * state["h"] + b[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    new_tail = torch.cat([tail[:, 1:], branch.to(tail.dtype)], dim=1)
    return out, {"h": h, "conv": new_tail}

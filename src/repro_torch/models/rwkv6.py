"""RWKV-6 "Finch" time-mix (arXiv:2404.05892): data-dependent per-channel
decay linear recurrence.

Prefill uses the JAX package's *chunked* parallel form (GLA-style): within
a chunk of L = ``cfg.rwkv_chunk`` tokens all work is dense einsums, and the
(B, H, N, N) state is carried from chunk to chunk by a Python loop (the JAX
``lax.scan``), in f32.  The pairwise decay exponent ``p_excl[t] - P[s]`` is
computed explicitly per (t, s, n) and is <= 0 for s < t, so the chunked
form cannot overflow at any decay rate.  Decode is the one-token
recurrence.

State layout (decode):  {"S": (B, H, N, N) f32, "x_prev": (B, 1, d)}
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.distributed.act_sharding import constrain
from repro_torch.models.layers import (STATELESS, Init, _local, check_mode, dtype_of,
                                       merge_heads, split_heads)

f32 = torch.float32

TIME_MIX_EXTRA_DIM = 32


def init_timemix(cfg: ModelConfig, seg: Segment, mk: Init) -> dict:
    d = cfg.d_model
    H, N = cfg.rwkv_n_heads, cfg.rwkv_head_size
    A, D = TIME_MIX_EXTRA_DIM, cfg.rwkv_decay_lora
    return {
        "mu_x": mk.full((d,), 0.5),
        "mu_5": mk.full((5, d), 0.5),  # base mix for (w, k, v, r, g)
        "tm_w1": mk.normal((d, 5 * A)),
        "tm_w2": mk.normal((5, A, d), scale=0.1 / math.sqrt(A)),
        "wr": mk.normal((d, d)),
        "wk": mk.normal((d, d)),
        "wv": mk.normal((d, d)),
        "wg": mk.normal((d, d)),
        "w0": mk.full((d,), -6.0, dtype=f32),  # decay base: w = -exp(w0 + lora)
        "wd_w1": mk.normal((d, D)),
        "wd_w2": mk.normal((D, d), scale=0.1 / math.sqrt(D)),
        "u": mk.normal((H, N), scale=0.1, dtype=f32),  # bonus
        "ln_scale": mk.full((d,), 1.0),
        "ln_bias": mk.full((d,), 0.0),
        "wo": mk.normal((d, d)),
    }


def _ddlerp(p: dict, x: torch.Tensor, xs: torch.Tensor):
    """Data-dependent token-shift mixing -> the 5 projected inputs."""
    dx = xs - x
    xxx = x + dx * p["mu_x"]
    a = torch.tanh(xxx @ p["tm_w1"])  # (B, S, 5A)
    B, S, _ = a.shape
    a = split_heads(a, B, S, 5, TIME_MIX_EXTRA_DIM)
    mix = torch.einsum("bsfa,fad->bsfd", a, p["tm_w2"].to(a.dtype)) + p["mu_5"]
    return [x + dx * mix[:, :, i] for i in range(5)]


def _project(cfg: ModelConfig, p: dict, x: torch.Tensor, xs: torch.Tensor):
    H, N = cfg.rwkv_n_heads, cfg.rwkv_head_size
    B, S, d = x.shape
    m_w, m_k, m_v, m_r, m_g = _ddlerp(p, x, xs)
    r = constrain(split_heads(m_r @ p["wr"], B, S, H, N), "dp", None, "tp", None)
    k = constrain(split_heads(m_k @ p["wk"], B, S, H, N), "dp", None, "tp", None)
    v = constrain(split_heads(m_v @ p["wv"], B, S, H, N), "dp", None, "tp", None)
    g = constrain(F.silu(m_g @ p["wg"]), "dp", None, "tp")
    # log decay, strictly negative; (B, S, H, N)
    lw = -torch.exp(p["w0"] + (torch.tanh(m_w @ p["wd_w1"]) @ p["wd_w2"]).float())
    return r, k, v, g, split_heads(lw, B, S, H, N)


def _group_norm(cfg: ModelConfig, p: dict, y: torch.Tensor) -> torch.Tensor:
    """Per-head group norm over (H, N) -> flattened d, in f32."""
    B, S, H, N = y.shape
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = merge_heads((yf - mu) * torch.rsqrt(var + 64e-5), B, S, H * N)
    return yn * p["ln_scale"].float() + p["ln_bias"].float()


def _chunk_scan(r, k, v, lw, u, S0, chunk: int = 32):
    """Chunked WKV6: r,k,v,lw (B, S, H, N) f32; S0 (B, H, N, N) f32.

    Returns (y (B,S,H,N), S_final).  S is the k->v linear map:
        y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
    """
    B, S, H, N = r.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # zero k/v/r and zero log-decay (decay=1) leave the state untouched
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    t_idx = torch.arange(L, device=r.device)
    causal = (t_idx[:, None] > t_idx[None, :])[None, :, :, None, None]
    eye = torch.eye(L, device=r.device)[None, :, None, :]
    Sprev, ys = S0, []
    for c0 in range(0, S + pad, L):
        rr, kk, vv, ww = (t[:, c0:c0 + L] for t in (r, k, v, lw))  # (B, L, H, N)
        P = torch.cumsum(ww, dim=1)  # inclusive log-decay prefix
        p_excl = P - ww
        # inter-chunk: state contribution decayed to each t
        y = torch.einsum("blhn,bhnm->blhm", rr * torch.exp(p_excl), Sprev)
        # intra-chunk pairwise decays (always <= 0 where used)
        D = p_excl[:, :, None, :, :] - P[:, None, :, :, :]  # (B, t, s, H, N)
        E = torch.where(causal, D, -torch.inf)
        A = torch.einsum("bthn,bshn,btshn->bths", rr, kk, torch.exp(E))
        diag = torch.einsum("bthn,hn,bthn->bth", rr, u, kk)  # bonus on s == t
        A = A + diag[:, :, :, None] * eye
        ys.append(y + torch.einsum("bths,bshm->bthm", A, vv))
        # state update: S_new = diag(exp(P_L)) S + sum_s (k_s e^{P_L - P_s}) v_s^T
        kd = kk * torch.exp(P[:, -1:] - P)
        Sprev = torch.exp(P[:, -1])[..., None] * Sprev + torch.einsum("blhn,blhm->bhnm", kd, vv)
    return torch.cat(ys, dim=1)[:, :S], Sprev


def _chunk_scan_blocks(r, k, v, lw, u, S0, chunk: int = 32):
    """``_chunk_scan`` on each rank's block when r is a DTensor: the scan is
    independent per sequence and per head, so the blocks keep r's batch and
    head shards (u's heads and S0's batch and heads laid out to match) and
    gather the sequence and the head size."""
    if not isinstance(r, DTensor):
        return _chunk_scan(r, k, v, lw, u, S0, chunk)
    mesh = r.device_mesh
    pl = [p if (p.is_shard() and p.dim in (0, 2)) else Replicate() for p in r.placements]
    u_pl = [Shard(0) if (p.is_shard() and p.dim == 2) else Replicate() for p in pl]
    s_pl = [Shard(1) if (p.is_shard() and p.dim == 2) else p for p in pl]
    y, S_fin = _chunk_scan(*(_local(t, mesh, pl) for t in (r, k, v, lw)), _local(u, mesh, u_pl),
                           _local(S0, mesh, s_pl), chunk)
    return DTensor.from_local(y, mesh, pl), DTensor.from_local(S_fin, mesh, s_pl)


def _step(r1, k1, v1, lw1, Sm, u):
    """One decode step of the recurrence: r1, k1, v1, lw1 (B, H, N), Sm (B,
    H, N, N) -> (y (B, H, N), the new state)."""
    kv = torch.einsum("bhn,bhm->bhnm", k1, v1)
    y = torch.einsum("bhn,bhnm->bhm", r1, Sm + u[None, :, :, None] * kv)
    return y, torch.exp(lw1)[..., None] * Sm + kv


def _step_blocks(r1, k1, v1, lw1, Sm, u):
    """``_step`` on each rank's block when r1 is a DTensor: the blocks keep
    the state's batch and head shards, as ``_chunk_scan_blocks`` does."""
    if not isinstance(r1, DTensor):
        return _step(r1, k1, v1, lw1, Sm, u)
    mesh = r1.device_mesh
    sp = Sm.placements if isinstance(Sm, DTensor) else [Replicate()] * mesh.ndim
    pl = [p if (p.is_shard() and p.dim in (0, 1)) else Replicate() for p in sp]
    u_pl = [Shard(0) if (p.is_shard() and p.dim == 1) else Replicate() for p in pl]
    y, S_new = _step(*(_local(t, mesh, pl) for t in (r1, k1, v1, lw1, Sm)),
                     _local(u, mesh, u_pl))
    return DTensor.from_local(y, mesh, pl), DTensor.from_local(S_new, mesh, pl)


def timemix_init_state(cfg: ModelConfig, batch: int, device=None):
    H, N = cfg.rwkv_n_heads, cfg.rwkv_head_size
    return {"S": torch.zeros((batch, H, N, N), dtype=f32, device=device),
            "x_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dtype_of(cfg), device=device)}


def apply_timemix(cfg: ModelConfig, seg: Segment, p: dict, x: torch.Tensor, *, mode: str,
                  state=None, **_unused):
    check_mode(mode)
    B, S, d = x.shape
    H, N = cfg.rwkv_n_heads, cfg.rwkv_head_size
    u = p["u"]

    if mode != "decode":
        # x and its shifted copy with the batch sharded only: DTensor may
        # shard the sequence, and the products flatten (batch, sequence)
        x = constrain(x, "dp", None, None)
        xs = constrain(F.pad(x, (0, 0, 1, 0))[:, :-1], "dp", None, None)
        r, k, v, g, lw = _project(cfg, p, x, xs)
        S0 = torch.zeros((B, H, N, N), dtype=f32, device=x.device)
        y, S_fin = _chunk_scan_blocks(r.float(), k.float(), v.float(), lw, u, S0,
                                      chunk=cfg.rwkv_chunk)
        out = (_group_norm(cfg, p, y).to(x.dtype) * g) @ p["wo"]
        if mode in STATELESS:
            return out, None
        return out, {"S": S_fin, "x_prev": x[:, -1:, :]}

    # decode
    r, k, v, g, lw = _project(cfg, p, x, state["x_prev"])
    y, S_new = _step_blocks(r[:, 0].float(), k[:, 0].float(), v[:, 0].float(), lw[:, 0],
                            state["S"], u)
    out = (_group_norm(cfg, p, y[:, None]).to(x.dtype) * g) @ p["wo"]
    return out, {"S": S_new, "x_prev": x}

"""Layer library, dense subset: norms, RoPE, GQA attention, SwiGLU FFN.

Conventions (as in the JAX package's ``models/layers.py``)
----------------------------------------------------------
* Parameters are plain nested dicts of tensors.  Weights keep the JAX
  layout: ``x @ W`` with ``W`` of shape ``(in, out)``.
* Apply functions are mode-polymorphic:

    mode='prefill'  full sequence, returns a decode state
    mode='decode'   one new token per sequence, consumes + returns state

* Prefill attention is plain PyTorch (einsum, then an f32 softmax with the
  ``-1e30`` mask).  Decode attention is the Hopper kernel
  ``kernels.decode_attention`` (its plain version for CPU tensors).
* Sharding annotations (``constrain``) have no counterpart on one card and
  are dropped.

Outside the subset (raise ``NotImplementedError``): the local ring window,
the int8 KV cache and ``qkv_bias`` (ROADMAP queue A item 3); MLA, MoE,
RWKV, RG-LRU, cross-attention and the other FFNs (ROADMAP queue A item 5).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.kernels.decode_attention import decode_attention

Params = dict
f32 = torch.float32

_ROADMAP_DENSE = "ROADMAP.md queue A item 3 (dense model follow-ups)"
_ROADMAP_ZOO = "ROADMAP.md queue A item 5 (rest of the model zoo)"


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` outside the port's dense subset."""
    for seg in cfg.segments:
        if seg.mixer == "local_attn":
            raise NotImplementedError(f"local ring-window attention: {_ROADMAP_DENSE}")
        if seg.mixer != "attn":
            raise NotImplementedError(f"mixer {seg.mixer!r}: {_ROADMAP_ZOO}")
        if seg.ffn != "swiglu":
            raise NotImplementedError(f"ffn {seg.ffn!r}: {_ROADMAP_ZOO}")
        if seg.cross_attn:
            raise NotImplementedError(f"cross-attention: {_ROADMAP_ZOO}")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(f"int8 KV cache: {_ROADMAP_DENSE}")
    if cfg.qkv_bias:
        raise NotImplementedError(f"qkv_bias: {_ROADMAP_DENSE}")
    if cfg.pos_emb != "rope":
        raise NotImplementedError(f"pos_emb {cfg.pos_emb!r}: {_ROADMAP_ZOO}")
    if cfg.is_encoder_decoder or cfg.n_prefix_embeds:
        raise NotImplementedError(f"encoder / prefix embeddings: {_ROADMAP_ZOO}")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    var = (xf**2).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps)
    return (y * p["scale"].float()).to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (Qwen3); eps is fixed at 1e-6 as in the JAX package."""
    xf = x.float()
    y = xf * torch.rsqrt((xf**2).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Positional embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(d: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=f32, device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# Prefill attention (plain PyTorch)
# ---------------------------------------------------------------------------


def _sdpa_block(q, k, v, mask, scale):
    """q:(B,Sq,H,dh) k,v:(B,Sk,KV,dh) mask:(B?,Sq,Sk) or None -> (B,Sq,H,dh)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.reshape(B, Sq, KV, G, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool, q_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Causal attention in query chunks, each against only the keys it may
    see (``[0, q_offset + q1)``), so the work is ~S^2/2, not S^2.

    q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh).
    """
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    if not causal:
        return _sdpa_block(q, k, v, None, scale)
    qc = min(q_chunk, Sq)
    outs = []
    for q0 in range(0, Sq, qc):
        q1 = min(q0 + qc, Sq)
        hi = min(q_offset + q1, Sk)
        qpos = q_offset + torch.arange(q0, q1, device=q.device)
        kpos = torch.arange(0, hi, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        outs.append(_sdpa_block(q[:, q0:q1], k[:, :hi], v[:, :hi], mask[None], scale))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Dense attention mixer (GQA, optional qk-norm)
# ---------------------------------------------------------------------------


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions):
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"])
        k = rms_norm_headwise(k, p["k_norm"])
    if cfg.pos_emb == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_init_state(cfg: ModelConfig, seg: Segment, batch: int, max_len: int,
                         device=None) -> Params:
    """Decode-state skeleton (zeros) for one attention layer."""
    check_supported(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


def _scatter_time(cache: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Write new (B, 1, ...) at per-sequence time position lengths (B,).

    Updates ``cache`` IN PLACE (the JAX version returns a new array and
    relies on buffer donation for the same effect) and returns it.  Like
    ``lax.dynamic_update_slice``, a position past the end is clamped to the
    last row.
    """
    B, S = cache.shape[:2]
    pos = lengths.long().clamp(0, S - 1)
    cache[torch.arange(B, device=cache.device), pos] = new[:, 0].to(cache.dtype)
    return cache


def apply_attention(cfg: ModelConfig, seg: Segment, p: Params, x: torch.Tensor, *,
                    mode: str, positions: torch.Tensor, state: Optional[Params] = None,
                    cache_len: Optional[torch.Tensor] = None, max_len: int = 0):
    """Returns (out, new_state).  In decode mode ``state`` is updated in place."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.d_head
    q, k, v = _qkv(cfg, p, x, positions)

    if mode == "prefill":
        out = blocked_attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk)
        shape = (B, max_len, cfg.n_kv_heads, dh)
        st = {"k": torch.zeros(shape, dtype=k.dtype, device=k.device),
              "v": torch.zeros(shape, dtype=v.dtype, device=v.device)}
        st["k"][:, :S] = k
        st["v"][:, :S] = v
        return out.reshape(B, S, H * dh) @ p["wo"], st

    if mode != "decode":
        raise NotImplementedError(f"mode {mode!r}: training is ROADMAP.md queue A item 6")
    # decode: S == 1, per-sequence write at cache_len, then attention over
    # the cache_len + 1 valid rows (>= 1, so an empty slot attends to one row)
    k_new = _scatter_time(state["k"], k, cache_len)
    v_new = _scatter_time(state["v"], v, cache_len)
    out = decode_attention(q.reshape(B, H, dh), k_new, v_new,
                           (cache_len + 1).to(torch.int32))
    return out.reshape(B, S, H * dh) @ p["wo"], {"k": k_new, "v": v_new}


# ---------------------------------------------------------------------------
# FFN (SwiGLU)
# ---------------------------------------------------------------------------


def _act(cfg: ModelConfig, x):
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return F.silu(x)


def apply_ffn(cfg: ModelConfig, seg: Segment, p: Params, x):
    """SwiGLU: (act(x @ w1) * (x @ w3)) @ w2."""
    if seg.ffn != "swiglu":
        raise NotImplementedError(f"ffn {seg.ffn!r}: {_ROADMAP_ZOO}")
    return (_act(cfg, x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]

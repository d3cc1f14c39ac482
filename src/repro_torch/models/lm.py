"""Language model over a stack of dense decoder layers (the port's subset).

Entry points (functions of ``(params, cfg, ...)``, as in the JAX package):

  init_params(cfg, generator, device=...)        -> params dict
  prefill(params, cfg, tokens, max_len=...)      -> (last_logits, DecodeState)
  decode_step(params, cfg, tokens, state)        -> (logits, DecodeState)
  init_decode_state(cfg, batch, max_len, ...)    -> DecodeState (zeros)

DecodeState = {"cache_len": (B,) i32, "segments": list[per-segment state]}.
Per segment the parameters and the decode state are stacked on a leading
layer axis, as in the JAX pytree; the JAX ``lax.scan`` over a segment's
layers is a Python loop over that axis.  ``decode_step`` writes the new K/V
rows into ``state`` in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    apply_attention,
    apply_ffn,
    apply_norm,
    attention_init_state,
    check_supported,
    dtype_of,
)

f32 = torch.float32


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _normal(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=f32, device=device) * scale).to(dtype)


def _init_segment(cfg: ModelConfig, seg: Segment, gen, device) -> dict:
    dt = dtype_of(cfg)
    L, d, H, KV, dh, ff = seg.repeat, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff

    def dense(fan_in, fan_out):  # normal / sqrt(fan_in), stacked over layers
        return _normal(gen, (L, fan_in, fan_out), 1.0 / math.sqrt(fan_in), dt, device)

    def ones(n):
        return torch.ones((L, n), dtype=dt, device=device)

    mixer = {"wq": dense(d, H * dh), "wk": dense(d, KV * dh),
             "wv": dense(d, KV * dh), "wo": dense(H * dh, d)}
    if cfg.qk_norm:
        mixer["q_norm"] = ones(dh)
        mixer["k_norm"] = ones(dh)
    return {
        "norm1": {"scale": ones(d)},
        "mixer": mixer,
        "norm2": {"scale": ones(d)},
        "ffn": {"w1": dense(d, ff), "w3": dense(d, ff), "w2": dense(ff, d)},
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device="cuda") -> dict:
    """Random parameters with the JAX package's scales: weights
    normal/sqrt(fan_in), embedding normal * 0.02, norm scales one.

    Draws from ``generator`` (a ``torch.Generator`` on ``device``), or from a
    new one seeded with ``seed``.  The numbers differ from ``jax.random``'s;
    parity tests convert the JAX parameters instead (``models.convert``).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    if cfg.norm_type == "layernorm":
        raise NotImplementedError("layernorm parameters: ROADMAP.md queue A item 5")
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    dt = dtype_of(cfg)
    params: dict = {
        "embed": _normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dt, dev),
        "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dt, device=dev)},
        "segments": [_init_segment(cfg, seg, generator, dev) for seg in cfg.segments],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(generator, (cfg.d_model, cfg.vocab_size),
                                    1.0 / math.sqrt(cfg.d_model), dt, dev)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer i's slice of a stacked (leading layer axis) tree: views, no copy."""
    if isinstance(tree, dict):
        return {key: _layer(val, i) for key, val in tree.items()}
    return tree[i]


def _apply_block(cfg, seg, p, x, *, mode, positions, state, cache_len, max_len):
    h = apply_norm(cfg, p["norm1"], x)
    mix_out, mix_st = apply_attention(
        cfg, seg, p["mixer"], h, mode=mode, positions=positions,
        state=None if state is None else state["mixer"],
        cache_len=cache_len, max_len=max_len)
    x = x + mix_out
    h = apply_norm(cfg, p["norm2"], x)
    x = x + apply_ffn(cfg, seg, p["ffn"], h)
    return x, {"mixer": mix_st}


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(dtype_of(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def _head_weights(cfg: ModelConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T.to(dtype_of(cfg))
    return params["lm_head"]


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int):
    """tokens (B, S) -> (last-token logits (B, V) f32, DecodeState)."""
    check_supported(cfg)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    states = []
    for seg, sp in zip(cfg.segments, params["segments"]):
        layer_states = []
        for i in range(seg.repeat):
            x, st = _apply_block(cfg, seg, _layer(sp, i), x, mode="prefill",
                                 positions=positions, state=None, cache_len=None,
                                 max_len=max_len)
            layer_states.append(st)
        states.append({"mixer": {
            name: torch.stack([st["mixer"][name] for st in layer_states])
            for name in ("k", "v")}})
    h = apply_norm(cfg, params["final_norm"], x)
    logits = (h[:, -1, :] @ _head_weights(cfg, params)).float()
    state = {
        "cache_len": torch.full((B,), S, dtype=torch.int32, device=x.device),
        "segments": states,
    }
    return logits, state


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, state: dict):
    """tokens (B,) new token per sequence -> (logits (B, V) f32, DecodeState).

    Each layer's K/V cache in ``state`` is updated in place; the returned
    state holds the same cache tensors and ``cache_len + 1``.
    """
    cache_len = state["cache_len"]
    x = _embed(cfg, params, tokens[:, None])
    positions = cache_len[:, None]
    for seg, sp, st in zip(cfg.segments, params["segments"], state["segments"]):
        for i in range(seg.repeat):
            x, _ = _apply_block(cfg, seg, _layer(sp, i), x, mode="decode",
                                positions=positions, state=_layer(st, i),
                                cache_len=cache_len, max_len=0)
    h = apply_norm(cfg, params["final_norm"], x)
    logits = (h[:, 0, :] @ _head_weights(cfg, params)).float()
    return logits, {"cache_len": cache_len + 1, "segments": state["segments"]}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, filled: int = 0,
                      *, device="cuda") -> dict:
    """Zero decode state with capacity ``max_len`` and ``filled`` tokens."""
    dev = resolve_device(device)
    segs = []
    for seg in cfg.segments:
        one = attention_init_state(cfg, seg, batch, max_len, device=dev)
        segs.append({"mixer": {name: torch.zeros((seg.repeat,) + t.shape, dtype=t.dtype,
                                                 device=dev)
                               for name, t in one.items()}})
    return {
        "cache_len": torch.full((batch,), filled, dtype=torch.int32, device=dev),
        "segments": segs,
    }

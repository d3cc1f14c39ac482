"""Analytic per-device HBM traffic model (the roofline memory term).

Why analytic: XLA:CPU applies far less fusion than XLA:TPU, so the
``bytes accessed`` cost-analysis metric on this container over-counts HBM
traffic by 2-3 orders of magnitude (every unfused elementwise op's operands
are charged).  The memory term is therefore computed from an explicit
traffic model, with the XLA number reported alongside as the no-fusion upper
bound.  All formulas below count bytes *per device per step*; weights are
assumed fully sharded (FSDP x TP, so local shard = W/chips) but *gathered
per layer* during compute, hence each device streams the **full** weight
bytes through HBM once per traversal — matching how XLA materialises
all-gathered operands.

train   : 2 weight reads (fwd+bwd, bf16) + grad f32 write+read
          + AdamW (mu, nu read+write f32; param read+write)
          + activations: ~14 bf16 (B,S,d)-equivalents per layer forward,
            x (1 fwd + 1 remat + 1 bwd read) + grad acts written once
          + attention scores: 3 x causal-half B H S^2 f32 (fwd/remat/bwd)
          + logits: 3 x (B,S,V) bf16 (chunked: fwd + remat + grad)
prefill : 1 weight read + 1x activations + KV-cache write
decode  : 1 weight read (the gathered stream — decode is weight-bound)
          + KV-cache read+write + small activations
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

BF16 = 2
F32 = 4


def _attention_score_bytes(cfg: ModelConfig, B: int, S: int, passes: float) -> float:
    """Causal-half score tensors, f32, summed over quadratic layers."""
    total = 0.0
    for seg in tuple(cfg.segments) + tuple(cfg.encoder_segments):
        if seg.mixer in ("attn", "mla", "encoder_attn"):
            eff = S * S if seg.mixer == "encoder_attn" else S * S / 2
            total += seg.repeat * B * cfg.n_heads * eff * F32
        elif seg.mixer == "local_attn":
            w = min(cfg.local_window, S)
            total += seg.repeat * B * cfg.n_heads * S * w * F32
        if seg.cross_attn:
            total += seg.repeat * B * cfg.n_heads * S * cfg.encoder_seq * F32
    return passes * total * 2  # write + read


def _kv_cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    total = 0.0
    kv_b = 1 + 4.0 / max(cfg.d_head, 1) if cfg.kv_cache_dtype == "int8" else BF16
    for seg in cfg.segments:
        if seg.mixer in ("attn", "encoder_attn"):
            total += seg.repeat * 2 * B * S * cfg.n_kv_heads * cfg.d_head * kv_b
        elif seg.mixer == "local_attn":
            w = min(cfg.local_window, S)
            total += seg.repeat * 2 * B * w * cfg.n_kv_heads * cfg.d_head * kv_b
        elif seg.mixer == "mla":
            total += seg.repeat * B * S * (cfg.kv_lora_rank + cfg.rope_head_dim) * BF16
        elif seg.mixer == "rwkv6":
            total += seg.repeat * B * cfg.rwkv_n_heads * cfg.rwkv_head_size**2 * F32
        elif seg.mixer == "rglru":
            total += seg.repeat * B * (cfg.lru_width or cfg.d_model) * F32
        if seg.cross_attn:
            total += seg.repeat * 2 * B * cfg.encoder_seq * cfg.n_kv_heads * cfg.d_head * BF16
    return total


ACT_TENSORS_PER_LAYER = 14  # qkv/gates/ffn-hidden(≈8x d wide counted via d_ff)


def _activation_bytes(cfg: ModelConfig, B: int, S: int, tp: int) -> float:
    """Forward activation traffic of one pass, bf16, for one dp shard
    (caller divides by dp).  d-wide tensors are dp-sharded only; ff/head-wide
    tensors are additionally tp-sharded."""
    per_tok = 0.0
    for seg in tuple(cfg.segments) + tuple(cfg.encoder_segments):
        d_ff = cfg.moe_d_ff * cfg.moe_top_k if seg.ffn == "moe" else cfg.d_ff
        shared = cfg.moe_d_ff * cfg.n_shared_experts if seg.ffn == "moe" else 0
        # ~6 d-wide tensors + 3 ff-wide tensors per layer, write+read
        per_tok += seg.repeat * (6 * cfg.d_model + 3 * (d_ff + shared) / tp) * BF16 * 2
    return B * S * per_tok


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                       tp: int = 16) -> dict:
    """Per-device HBM bytes/step.  tp = model-axis size; weights are TP-kept
    and DP-gathered, so one weight traversal streams W/tp bytes per device.
    Activations: d-wide tensors shard over dp only; ff/head-wide over dp*tp."""
    B, S = shape.global_batch, shape.seq_len
    dp = max(chips // tp, 1)
    W = cfg.param_count()
    W_local = W / chips

    if shape.kind == "train":
        weights = 2 * W * BF16 / tp  # fwd + bwd reads of the gathered stream
        opt = W_local * (2 * F32 + 4 * F32 + 2 * F32)  # grad w+r, mu/nu rw, param rw
        acts = _activation_bytes(cfg, B, S, tp) * 3 / dp  # fwd + remat + bwd
        scores = _attention_score_bytes(cfg, B, S, passes=3.0) / chips
        logits = 3 * B * S * cfg.vocab_size * BF16 / chips
        total = weights + opt + acts + scores + logits
        parts = {"weights": weights, "optimizer": opt, "activations": acts,
                 "attn_scores": scores, "logits": logits}
    elif shape.kind == "prefill":
        weights = W * BF16 / tp
        acts = _activation_bytes(cfg, B, S, tp) / dp
        scores = _attention_score_bytes(cfg, B, S, passes=1.0) / chips
        kv = _kv_cache_bytes(cfg, B, S) / chips
        logits = B * cfg.vocab_size * BF16 / chips  # last-position head only
        total = weights + acts + scores + kv + logits
        parts = {"weights": weights, "activations": acts, "attn_scores": scores,
                 "kv_cache_write": kv, "logits": logits}
    else:  # decode
        weights = W * BF16 / tp
        kv = _kv_cache_bytes(cfg, B, S) / chips  # full cache read
        acts = B * (cfg.n_layers + cfg.n_encoder_layers) * cfg.d_model * 20 * BF16 / dp
        logits = B * cfg.vocab_size * F32 / chips
        total = weights + kv + acts + logits
        parts = {"weights": weights, "kv_cache_read": kv, "activations": acts,
                 "logits": logits}
    parts["total"] = total
    return parts

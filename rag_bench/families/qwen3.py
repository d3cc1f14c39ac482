"""Qwen3 (HF ``Qwen3ForCausalLM``): grouped-query attention over the whole
context with per-head qk-norm, a SwiGLU FFN in every layer."""
from __future__ import annotations

from rag_bench.harness.peaks import Layer

TINY = {"n_kv_heads": 2}
WEIGHTS: dict = {}


def port(f: dict) -> dict:
    return dict(n_kv_heads=f["num_key_value_heads"], d_head=f["head_dim"],
                d_ff=f["intermediate_size"], qk_norm=True, qkv_bias=f["attention_bias"],
                segments=(("attn", "swiglu", f["num_hidden_layers"]),))


def tiny_view(mc) -> dict:
    return dict(num_key_value_heads=mc.n_kv_heads, head_dim=mc.d_head, intermediate_size=mc.d_ff)


def layers(f: dict) -> list:
    d, H = f["hidden_size"], f["num_attention_heads"]
    dh, kv = f["head_dim"], f["num_key_value_heads"]
    attn = d * H * dh + 2 * d * kv * dh + H * dh * d
    ffn = 3 * d * f["intermediate_size"]
    return [Layer(attn + ffn, H, dh, dh)] * f["num_hidden_layers"]

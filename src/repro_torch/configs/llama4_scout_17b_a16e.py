"""llama4-scout-17b-a16e — Llama-4 Scout MoE (hf:meta-llama/Llama-4-Scout-17B-16E).

48L, d_model=5120, 40 heads (GQA kv=8, d_head=128), vocab 202048.
Every layer: 16 routed experts top-1 + 1 shared expert, expert d_ff=8192.
Early-fusion multimodality is out of backbone scope (text tokens only here).
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202048,
    segments=(Segment(mixer="attn", ffn="moe", repeat=48),),
    n_experts=16,
    n_shared_experts=1,
    moe_top_k=1,
    moe_d_ff=8192,
    rope_theta=500_000.0,
)

"""qwen3-1.7b — Qwen3 family (hf:Qwen/Qwen3-*): qk_norm + GQA.

28L, d_model=2048, 16 heads (GQA kv=8, d_head=128), SwiGLU d_ff=6144,
vocab 151936, RoPE theta 1e6, per-head RMS qk-norm.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab_size=151936,
    segments=(Segment(mixer="attn", ffn="swiglu", repeat=28),),
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
)

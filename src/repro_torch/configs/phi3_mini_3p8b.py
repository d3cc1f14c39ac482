"""phi3-mini-3.8b — Phi-3-mini (arXiv:2404.14219): RoPE SwiGLU GQA.

32L, d_model=3072, 32 heads (kv=32 -> MHA, d_head=96), SwiGLU d_ff=8192,
vocab 32064.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab_size=32064,
    segments=(Segment(mixer="attn", ffn="swiglu", repeat=32),),
    rope_theta=10000.0,
)

"""qwen1.5-110b — Qwen1.5 family (hf:Qwen/Qwen1.5-*): QKV bias.

80L, d_model=8192, 64 heads (GQA kv=8, d_head=128), SwiGLU d_ff=49152,
vocab 152064.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab_size=152064,
    segments=(Segment(mixer="attn", ffn="swiglu", repeat=80),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

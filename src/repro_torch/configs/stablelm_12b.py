"""stablelm-12b — Stability AI StableLM-2-12B family (hf:stabilityai).

40L, d_model=5120, 32 heads (GQA kv=8, d_head=160), SwiGLU d_ff=13824,
vocab 100352, RoPE.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=160,
    d_ff=13824,
    vocab_size=100352,
    segments=(Segment(mixer="attn", ffn="swiglu", repeat=40),),
    rope_theta=10000.0,
)

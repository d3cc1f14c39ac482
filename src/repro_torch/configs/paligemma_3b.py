"""paligemma-3b — SigLIP + Gemma VLM (arXiv:2407.07726).

Gemma-2B text backbone: 18L, d_model=2048, 8 heads (MQA kv=1, d_head=256),
GeGLU d_ff=16384, vocab 257216.  The SigLIP vision tower is a STUB:
input_specs() provides 256 precomputed patch embeddings (batch, 256, d_model)
prepended as a prefix to the text tokens.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab_size=257216,
    segments=(Segment(mixer="attn", ffn="geglu", repeat=18),),
    n_prefix_embeds=256,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
)

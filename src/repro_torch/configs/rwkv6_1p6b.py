"""rwkv6-1.6b — RWKV-6 "Finch" (arXiv:2404.05892).

24L, d_model=2048, attention-free data-dependent-decay linear recurrence,
channel-mix FFN d_ff=7168, vocab 65536.  head_size 64 -> 32 wkv heads.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,        # wkv heads = d_model / head_size
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab_size=65536,
    segments=(Segment(mixer="rwkv6", ffn="rwkv_cmix", repeat=24),),
    pos_emb="none",
    rwkv_head_size=64,
    rwkv_decay_lora=64,
    norm_type="layernorm",
)

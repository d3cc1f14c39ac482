"""deepseek-v2-lite-16b — MLA + fine-grained MoE (arXiv:2405.04434).

27L, d_model=2048, 16 heads, MLA kv_lora_rank=512 (rope 64 / nope 128 /
v 128), vocab 102400.  Layer 0 dense SwiGLU (d_ff=10944); layers 1..26 MoE
with 64 routed experts top-6 + 2 shared experts, expert d_ff=1408.

Assignment note: headline says "MoE 64e top-6", parenthetical "160 routed" is
the full V2 config — we follow the headline 64-routed Lite config (matches the
released model).  Recorded in DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,  # MLA: per-head latent expansion, kv head count == n_heads
    d_head=192,     # nope 128 + rope 64
    d_ff=10944,     # dense layer 0
    vocab_size=102400,
    segments=(
        Segment(mixer="mla", ffn="swiglu", repeat=1),
        Segment(mixer="mla", ffn="moe", repeat=26),
    ),
    kv_lora_rank=512,
    q_lora_rank=0,  # V2-Lite drops the q-lora projection
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
)

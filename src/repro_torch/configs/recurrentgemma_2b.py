"""recurrentgemma-2b — Griffin RG-LRU + local attention, 1:2 (arXiv:2402.19427).

26L, d_model=2560, 10 heads (MQA kv=1, d_head=256), GeGLU d_ff=7680,
vocab 256000.  Layer pattern: (rglru, rglru, local_attn) repeating; 26 layers
= 8 x (R,R,A) + (R,R).  Local attention window 2048 -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, Segment

_PATTERN = []
for _ in range(8):
    _PATTERN.append(Segment(mixer="rglru", ffn="geglu", repeat=2))
    _PATTERN.append(Segment(mixer="local_attn", ffn="geglu", repeat=1))
_PATTERN.append(Segment(mixer="rglru", ffn="geglu", repeat=2))

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab_size=256000,
    segments=tuple(_PATTERN),
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
)

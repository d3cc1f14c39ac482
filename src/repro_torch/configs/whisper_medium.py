"""whisper-medium — enc-dec audio transformer (arXiv:2212.04356).

24L encoder + 24L decoder, d_model=1024, 16 heads MHA (d_head=64),
GELU MLP d_ff=4096, vocab 51865.  The conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (batch, frames, d_model); the encoder
runs bidirectional attention over them, decoder layers interleave causal
self-attention with cross-attention to the encoder output.
"""
from repro_torch.configs.base import ModelConfig, Segment

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51865,
    segments=(Segment(mixer="attn", ffn="gelu_mlp", repeat=24, cross_attn=True),),
    is_encoder_decoder=True,
    n_encoder_layers=24,
    encoder_segments=(Segment(mixer="encoder_attn", ffn="gelu_mlp", repeat=24),),
    encoder_seq=1500,  # 30 s of audio at 50 frames/s (stub embeddings)
    pos_emb="sinusoidal",
    norm_type="layernorm",
    act="gelu",
)

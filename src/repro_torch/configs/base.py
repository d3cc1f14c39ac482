"""Architecture + shape configuration system.

Every assigned architecture is expressed as a ``ModelConfig`` composed of
homogeneous ``Segment`` runs (mixer × ffn × repeat).  Segments are the unit of
``jax.lax.scan`` over layers: parameters inside a segment are stacked along a
leading layer axis, which keeps HLO size (and compile time) independent of
depth while still supporting heterogeneous stacks (hybrids, first-dense-then-
MoE, enc-dec).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------

MIXERS = ("attn", "local_attn", "mla", "rwkv6", "rglru", "encoder_attn", "cross_attn")
FFNS = ("swiglu", "gelu_mlp", "moe", "rwkv_cmix", "geglu")


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of ``repeat`` identical layers."""

    mixer: str
    ffn: str
    repeat: int
    cross_attn: bool = False  # decoder layers attending to encoder output

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in FFNS:
            raise ValueError(f"unknown ffn {self.ffn!r}")


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    segments: tuple[Segment, ...]

    # --- attention options -------------------------------------------------
    pos_emb: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    local_window: int = 0  # sliding-window size for local_attn

    # --- MLA (DeepSeek-V2) --------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0

    # --- RWKV6 --------------------------------------------------------------
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_chunk: int = 64

    # --- RG-LRU (RecurrentGemma / Griffin) ----------------------------------
    lru_width: int = 0
    conv_width: int = 4

    # --- encoder-decoder ----------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend sequence length (audio frames)
    encoder_segments: tuple[Segment, ...] = ()

    # --- multimodal prefix (VLM) --------------------------------------------
    n_prefix_embeds: int = 0  # precomputed patch embeddings prepended to text

    # --- serving ------------------------------------------------------------
    # 'bf16' (default) or 'int8': int8 stores KV with a per-(token, kv-head)
    # f32 scale — halves the decode memory stream (KIVI-style, beyond-paper
    # §Perf optimization)
    kv_cache_dtype: str = "bf16"

    # --- misc ---------------------------------------------------------------
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    dtype: str = "bfloat16"
    # attention implementation: q-chunk size for the online-softmax jnp path
    attn_q_chunk: int = 1024
    # cross-entropy loss seq-chunk size (bounds (B,S,V) logits materialisation)
    loss_chunk: int = 512
    remat: bool = True
    scan_layers: bool = True
    # unroll inner lax.scans (rwkv chunk loop) — used by the cost-analysis
    # depth variants because XLA cost_analysis counts while-loop bodies once
    unroll_scans: bool = False

    # ------------------------------------------------------------------ utils
    def __post_init__(self):
        n = sum(s.repeat for s in self.segments)
        if n != self.n_layers:
            raise ValueError(
                f"{self.name}: segments sum to {n} layers, expected {self.n_layers}"
            )
        if self.is_encoder_decoder:
            ne = sum(s.repeat for s in self.encoder_segments)
            if ne != self.n_encoder_layers:
                raise ValueError(
                    f"{self.name}: encoder segments sum to {ne}, expected "
                    f"{self.n_encoder_layers}"
                )

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def attention_free(self) -> bool:
        """True when no quadratic-in-sequence mixer exists (long-context OK)."""
        quad = {"attn", "mla", "encoder_attn"}
        return all(s.mixer not in quad for s in self.segments)

    @property
    def uses_moe(self) -> bool:
        return any(s.ffn == "moe" for s in self.segments)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs roofline)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        return _param_count(self, active_only=True)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=len(self.segments),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            segments=tuple(dataclasses.replace(s, repeat=1) for s in self.segments),
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            q_lora_rank=0,
            rope_head_dim=8 if self.kv_lora_rank else 64,
            nope_head_dim=16 if self.kv_lora_rank else 128,
            v_head_dim=16 if self.kv_lora_rank else 128,
            n_experts=4 if self.n_experts else 0,
            moe_top_k=min(2, self.moe_top_k) if self.moe_top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            # ample capacity: token drops are batch-shape-dependent, which
            # would break train-vs-decode consistency checks on tiny batches
            capacity_factor=8.0,
            n_shared_experts=min(1, self.n_shared_experts),
            rwkv_head_size=16,
            rwkv_decay_lora=8,
            rwkv_chunk=16,
            lru_width=64 if self.lru_width else 0,
            local_window=16 if self.local_window else 0,
            n_encoder_layers=len(self.encoder_segments),
            encoder_seq=8 if self.is_encoder_decoder else 0,
            encoder_segments=tuple(
                dataclasses.replace(s, repeat=1) for s in self.encoder_segments
            ),
            n_prefix_embeds=4 if self.n_prefix_embeds else 0,
            attn_q_chunk=32,
            loss_chunk=32,
            remat=False,
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d  # lm head
    seg_lists = [cfg.segments]
    if cfg.is_encoder_decoder:
        seg_lists.append(cfg.encoder_segments)
    for segs in seg_lists:
        for seg in segs:
            per_layer = 2 * d  # two norms
            # mixer
            if seg.mixer in ("attn", "local_attn", "encoder_attn"):
                per_layer += d * cfg.n_heads * cfg.d_head  # q
                per_layer += 2 * d * cfg.n_kv_heads * cfg.d_head  # k, v
                per_layer += cfg.n_heads * cfg.d_head * d  # o
            elif seg.mixer == "mla":
                qdim = cfg.nope_head_dim + cfg.rope_head_dim
                if cfg.q_lora_rank:
                    per_layer += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qdim
                else:
                    per_layer += d * cfg.n_heads * qdim
                per_layer += d * (cfg.kv_lora_rank + cfg.rope_head_dim)  # down
                per_layer += cfg.kv_lora_rank * cfg.n_heads * (
                    cfg.nope_head_dim + cfg.v_head_dim
                )  # up
                per_layer += cfg.n_heads * cfg.v_head_dim * d  # o
            elif seg.mixer == "rwkv6":
                per_layer += 4 * d * d + d * cfg.rwkv_decay_lora * 2  # r,k,v,g + decay lora
                per_layer += d * d  # output
            elif seg.mixer == "rglru":
                w = cfg.lru_width or d
                per_layer += 2 * d * w + w * d  # in x2 (branch+gate), out
                per_layer += cfg.conv_width * w + 2 * w  # conv + lru gates (approx)
            if seg.cross_attn:
                per_layer += d * cfg.n_heads * cfg.d_head * 2  # q, o
                per_layer += 2 * d * cfg.n_kv_heads * cfg.d_head  # k, v
                per_layer += d  # norm
            # ffn
            if seg.ffn == "swiglu" or seg.ffn == "geglu":
                per_layer += 3 * d * cfg.d_ff
            elif seg.ffn == "gelu_mlp":
                per_layer += 2 * d * cfg.d_ff
            elif seg.ffn == "rwkv_cmix":
                per_layer += 2 * d * cfg.d_ff + d * d
            elif seg.ffn == "moe":
                n_routed = cfg.moe_top_k if active_only else cfg.n_experts
                per_layer += 3 * d * cfg.moe_d_ff * n_routed
                per_layer += 3 * d * cfg.moe_d_ff * cfg.n_shared_experts
                per_layer += d * cfg.n_experts  # router
            total += per_layer * seg.repeat
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned per-arch shape set)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason).  long_500k only for sub-quadratic mixers."""
    if shape.name == "long_500k" and not cfg.attention_free:
        return False, "skipped: quadratic full attention at 500k context"
    return True, "ok"

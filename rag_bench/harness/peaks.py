"""The yardstick's arithmetic: the card's peaks, the bytes each kernel must
move for a call, and the model FLOPs of a step.  Everything is computed from
shapes and from the configuration file, never from the program.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
989 TFLOP/s in bf16, HBM at 3.35 TB/s.  A card set below 700 W runs
slower; the power limit is printed beside every run.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def decode_attention_bytes(lengths, kv_heads: int, head_dim: int, q_heads: int, batch: int,
                           elem: int = 2) -> int:
    """One ``decode_attention`` call over a bf16 cache: each slot's K and V
    rows up to its length read once, the queries read and the output
    written once, the lengths read (``chip_smoke.py``'s count)."""
    return (int(sum(lengths)) * kv_heads * head_dim * elem * 2
            + 2 * batch * q_heads * head_dim * elem + 4 * batch)


def ivf_scan_bytes(groups: int, qb: int, dim: int, k: int, rows_of_distinct_clusters: int,
                   slab_slots: int) -> int:
    """One ``ivf_scan`` call: the valid rows of each distinct probed cluster
    read once (f32), the query groups, the cluster ids and counts, the
    output (f32 distance and int32 index a result)."""
    return (rows_of_distinct_clusters * dim * 4 + groups * qb * dim * 4
            + 4 * (groups + slab_slots) + groups * qb * k * 8)


class ModelFlops:
    """Model FLOPs of a served model, from its configuration file: two per
    active parameter a token (every matrix a token passes through, the
    head included, the embedding lookup not), plus causal attention over
    the context (QK and PV, two FLOPs a multiply-add)."""

    def __init__(self, cfg: dict):
        d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
        H = cfg["num_attention_heads"]
        V = cfg["vocab_size"]
        if cfg["model_type"] == "qwen3":
            dh, kv = cfg["head_dim"], cfg["num_key_value_heads"]
            attn = d * H * dh + 2 * d * kv * dh + H * dh * d
            ffn = 3 * d * cfg["intermediate_size"]
            per_layer = [attn + ffn] * L
            self.qk_dim, self.v_dim = dh, dh
        elif cfg["model_type"] == "deepseek_v2":
            r, rp = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
            nope, vd = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
            attn = d * H * (nope + rp) + d * (r + rp) + r * H * (nope + vd) + H * vd * d
            dense = 3 * d * cfg["intermediate_size"]
            e_ff = cfg["moe_intermediate_size"]
            moe = (3 * d * e_ff * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
                   + d * cfg["n_routed_experts"])
            k = cfg["first_k_dense_replace"]
            per_layer = [attn + dense] * k + [attn + moe] * (L - k)
            self.qk_dim, self.v_dim = nope + rp, vd
        else:
            raise ValueError(f"no FLOP count for model_type {cfg['model_type']!r}")
        self.active_params = sum(per_layer) + d * V
        self.layers, self.heads = L, H

    def token(self, context: int) -> float:
        """FLOPs of one token attending to ``context`` positions (itself
        included)."""
        return (2.0 * self.active_params
                + 2.0 * self.layers * self.heads * context * (self.qk_dim + self.v_dim))

    def prefill(self, width: int) -> float:
        """A causal prefill of ``width`` tokens: sum of token(p + 1)."""
        return (2.0 * self.active_params * width
                + self.layers * self.heads * (self.qk_dim + self.v_dim) * width * (width + 1))

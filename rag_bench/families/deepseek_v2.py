"""DeepSeek-V2 (HF ``DeepseekV2ForCausalLM``): multi-head latent attention
over the whole context; the first ``first_k_dense_replace`` layers a dense
SwiGLU, every later one routed experts plus shared ones."""
from __future__ import annotations

from rag_bench.harness.peaks import Layer

TINY: dict = {}
WEIGHTS: dict = {}


def port(f: dict) -> dict:
    if (f.get("rope_scaling") or {}).get("factor", 1) != 1:
        raise ValueError("the port has no YaRN: rope_scaling runs only at factor 1")
    k, L = f["first_k_dense_replace"], f["num_hidden_layers"]
    return dict(kv_lora_rank=f["kv_lora_rank"], q_lora_rank=f["q_lora_rank"] or 0,
                rope_head_dim=f["qk_rope_head_dim"], nope_head_dim=f["qk_nope_head_dim"],
                v_head_dim=f["v_head_dim"], d_ff=f["intermediate_size"],
                moe_d_ff=f["moe_intermediate_size"], n_experts=f["n_routed_experts"],
                moe_top_k=f["num_experts_per_tok"], n_shared_experts=f["n_shared_experts"],
                segments=(("mla", "swiglu", k), ("mla", "moe", L - k)))


def tiny_view(mc) -> dict:
    return dict(kv_lora_rank=mc.kv_lora_rank, qk_rope_head_dim=mc.rope_head_dim,
                qk_nope_head_dim=mc.nope_head_dim, v_head_dim=mc.v_head_dim,
                intermediate_size=mc.d_ff, moe_intermediate_size=mc.moe_d_ff,
                n_routed_experts=mc.n_experts, num_experts_per_tok=mc.moe_top_k,
                n_shared_experts=mc.n_shared_experts,
                first_k_dense_replace=mc.segments[0].repeat)


def layers(f: dict) -> list:
    d, H = f["hidden_size"], f["num_attention_heads"]
    r, rp = f["kv_lora_rank"], f["qk_rope_head_dim"]
    nope, vd = f["qk_nope_head_dim"], f["v_head_dim"]
    attn = d * H * (nope + rp) + d * (r + rp) + r * H * (nope + vd) + H * vd * d
    dense = 3 * d * f["intermediate_size"]
    e_ff = f["moe_intermediate_size"]
    moe = (3 * d * e_ff * (f["num_experts_per_tok"] + f["n_shared_experts"])
           + d * f["n_routed_experts"])
    k, L = f["first_k_dense_replace"], f["num_hidden_layers"]
    return ([Layer(attn + dense, H, nope + rp, vd)] * k
            + [Layer(attn + moe, H, nope + rp, vd)] * (L - k))

"""DeepSeek-V2-Lite (arXiv:2405.04434; HF ``DeepseekV2ForCausalLM``) in plain
f32 PyTorch.

Per layer: RMSNorm, then multi-head latent attention without a query
low-rank: q = x Wq split per head into a no-position part (128) and a RoPE
part (64); the key-value latent c = RMSNorm(x Wkv_a[:, :512]) and a shared
RoPE key x Wkv_a[:, 512:]; per-head keys [c Wk_b, rope key] and values
c Wv_b; causal softmax at 1 / sqrt(192); the output projection and a
residual add.  Then RMSNorm and the FFN with a residual add: layer 0 a
dense SwiGLU (10944), every later layer 2 shared SwiGLU experts (one of
width 2 x 1408) plus 64 routed SwiGLU experts (1408) of which each token
takes the 6 with the highest softmax router probability (ties to the lower
index), weighted by those probabilities renormalised to sum 1
(``norm_topk_prob`` as run; ``routed_scaling_factor`` 1), with no capacity
limit.  A final RMSNorm and an untied head.

As run, and so here: ``rope_scaling`` the published YaRN group at factor
1 (published: 40), which is plain RoPE at theta 10000: at factor 1 YaRN
interpolates no frequency and both of its mscale terms are 1.  Any other
factor is refused, not run.  And the top-6 gates renormalised (published:
not); ``reduced`` lists both.  The rope dims are
rotated in rotate-half order (HF permutes its interleaved layout into that
order first; with seeded weights the layouts are the same model).

Weights in the serving program's tree layout (the benchmark's input
format): ``embed`` (V, d), ``lm_head`` (d, V), ``final_norm`` ``scale``;
segment 0 (the dense layer) and segment 1 (the MoE layers), each stacked
over its layers: ``norm1``/``norm2`` ``scale``, ``mixer`` ``wq`` (d,
H*192), ``wkv_a`` (d, 576), ``kv_norm`` (512,), ``wk_b`` and ``wv_b``
(512, H*128), ``wo`` (H*128, d); ``ffn`` ``w1``/``w3``/``w2`` (dense, or
per expert (E, d, ff) / (E, ff, d)), ``router`` (d, E) f32, shared
``sw1``/``sw3`` (d, 2816), ``sw2`` (2816, d).
"""
from __future__ import annotations

import torch

from .common import Precision, causal_attention, rms_norm, rope, swiglu


def _mla(x, m, i, cfg, pos, prec):
    S = x.shape[0]
    H = cfg["num_attention_heads"]
    r, rp = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    nope, vd = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    q = prec.mm(x, m["wq"][i]).view(S, H, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
    kv = prec.mm(x, m["wkv_a"][i])
    c = rms_norm(kv[:, :r], m["kv_norm"][i], eps)
    k_pe = rope(kv[:, None, r:], pos, theta)  # (S, 1, rp), shared by the heads
    k_nope = prec.mm(c, m["wk_b"][i]).view(S, H, nope)
    v = prec.mm(c, m["wv_b"][i]).view(S, H, vd)
    k = torch.cat([k_nope, k_pe.expand(S, H, rp)], -1)
    return prec.mm(causal_attention(q, k, v, prec).reshape(S, H * vd), m["wo"][i])


def _moe(x, f, i, cfg, prec):
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ f["router"][i].float(), dim=-1)  # (S, E)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :K], experts[:, :K]
    if cfg["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * cfg["routed_scaling_factor"]
    out = swiglu(x, f["sw1"][i], f["sw3"][i], f["sw2"][i], prec)
    for e in torch.unique(experts).tolist():
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        y = swiglu(x[tok], f["w1"][i, e], f["w3"][i, e], f["w2"][i, e], prec)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def logits_at(params: dict, cfg: dict, tokens: torch.Tensor, at: torch.Tensor,
              prec: Precision | None = None) -> torch.Tensor:
    """f32 logits (len(at), V) of the causal forward over ``tokens`` (S,),
    read at the positions ``at``; positions are 0 .. S - 1."""
    prec = prec or Precision()
    if (cfg.get("rope_scaling") or {}).get("factor", 1) != 1:
        raise ValueError("YaRN is implemented here only at factor 1, where it is plain RoPE")
    eps = cfg["rms_norm_eps"]
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens].float()
    layer = 0
    for seg in params["segments"]:
        for i in range(seg["norm1"]["scale"].shape[0]):
            x = x + _mla(rms_norm(x, seg["norm1"]["scale"][i], eps), seg["mixer"], i, cfg, pos,
                         prec)
            h = rms_norm(x, seg["norm2"]["scale"][i], eps)
            f = seg["ffn"]
            if layer < cfg["first_k_dense_replace"]:
                x = x + swiglu(h, f["w1"][i], f["w3"][i], f["w2"][i], prec)
            else:
                x = x + _moe(h, f, i, cfg, prec)
            layer += 1
    if layer != cfg["num_hidden_layers"]:
        raise ValueError(f"the weights hold {layer} layers, the configuration "
                         f"{cfg['num_hidden_layers']}")
    h = rms_norm(x[at], params["final_norm"]["scale"], eps)
    return prec.mm(h, params["lm_head"])

"""Qwen3 (arXiv:2505.09388; HF ``Qwen3ForCausalLM``) in plain f32 PyTorch.

Per layer: RMSNorm, grouped-query attention (q, k, v without bias; each
head's q and k RMS-normed over head_dim with its own scale; rotate-half
RoPE at theta ``rope_theta``; causal softmax at 1 / sqrt(head_dim)), the
output projection and a residual add; RMSNorm, SwiGLU (silu(x W1) * x W3,
then W2) and a residual add.  A final RMSNorm, and the head tied to the
embedding.  Every norm's epsilon is ``rms_norm_eps``.

The weights come in the serving program's tree layout, which is the input
format the benchmark hands both sides: ``embed`` (V, d), ``final_norm``
``scale``, and one segment whose leaves are stacked over the layers:
``norm1``/``norm2`` ``scale`` (L, d), ``mixer`` ``wq`` (L, d, H*dh), ``wk``
and ``wv`` (L, d, KV*dh), ``wo`` (L, H*dh, d), ``q_norm``/``k_norm`` (L, dh),
``ffn`` ``w1``/``w3`` (L, d, ff), ``w2`` (L, ff, d).  Each matrix maps x to
x @ W.  Departures from the published description: none in the arithmetic;
the weights are seeded random (``harness/weights.py``).
"""
from __future__ import annotations

import torch

from .common import Precision, causal_attention, rms_norm, rope, swiglu


def logits_at(params: dict, cfg: dict, tokens: torch.Tensor, at: torch.Tensor,
              prec: Precision | None = None) -> torch.Tensor:
    """f32 logits (len(at), V) of the causal forward over ``tokens`` (S,),
    read at the positions ``at``; positions are 0 .. S - 1."""
    prec = prec or Precision()
    H, KV, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens].float()
    seg = params["segments"][0]
    for i in range(cfg["num_hidden_layers"]):
        m, f = seg["mixer"], seg["ffn"]
        h = rms_norm(x, seg["norm1"]["scale"][i], eps)
        q = prec.mm(h, m["wq"][i]).view(S, H, dh)
        k = prec.mm(h, m["wk"][i]).view(S, KV, dh)
        v = prec.mm(h, m["wv"][i]).view(S, KV, dh)
        q = rope(rms_norm(q, m["q_norm"][i], eps), pos, theta)
        k = rope(rms_norm(k, m["k_norm"][i], eps), pos, theta)
        o = causal_attention(q, k, v, prec).reshape(S, H * dh)
        x = x + prec.mm(o, m["wo"][i])
        h = rms_norm(x, seg["norm2"]["scale"][i], eps)
        x = x + swiglu(h, f["w1"][i], f["w3"][i], f["w2"][i], prec)
    h = rms_norm(x[at], params["final_norm"]["scale"], eps)
    return prec.mm(h, params["embed"].T)

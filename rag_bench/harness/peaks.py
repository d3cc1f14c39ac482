"""The yardstick's arithmetic: the card's peaks, the bytes each kernel must
move for a call, and the model FLOPs of a step.  Everything is computed from
shapes and from the configuration file, never from the program.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
989 TFLOP/s in bf16, HBM at 3.35 TB/s.  A card set below 700 W runs
slower; the power limit is printed beside every run.
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple

from rag_bench import families

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def decode_attention_bytes(lengths, kv_heads: int, head_dim: int, q_heads: int, batch: int,
                           elem: int = 2, window: int = 0) -> int:
    """One ``decode_attention`` call over a bf16 cache: each slot's K and V
    rows up to its length (on a ring of ``window`` rows, at most
    ``window``; 0: no ring) read once, the queries read and the output
    written once, the lengths read (``chip_smoke.py``'s count)."""
    rows = sum(min(int(n), window) for n in lengths) if window else int(sum(lengths))
    return (rows * kv_heads * head_dim * elem * 2
            + 2 * batch * q_heads * head_dim * elem + 4 * batch)


def ivf_scan_bytes(groups: int, qb: int, dim: int, k: int, rows_of_distinct_clusters: int,
                   slab_slots: int) -> int:
    """One ``ivf_scan`` call: the valid rows of each distinct probed cluster
    read once (f32), the query groups, the cluster ids and counts, the
    output (f32 distance and int32 index a result)."""
    return (rows_of_distinct_clusters * dim * 4 + groups * qb * dim * 4
            + 4 * (groups + slab_slots) + groups * qb * k * 8)


class Layer(NamedTuple):
    """One layer as ``ModelFlops`` counts it (a family module's ``layers``)."""

    params: int  # the parameters a token passes through (active experts only)
    heads: int  # query heads
    qk_dim: int
    v_dim: int
    window: int = 0  # the positions a token attends to at most; 0: the whole context


def _attended(width: int, window: int) -> int:
    """Positions attended over a causal prefill of ``width`` tokens: the sum
    over p = 1 .. width of min(p, window), or of p where ``window`` is 0."""
    if not window or width <= window:
        return width * (width + 1) // 2
    return window * (window + 1) // 2 + (width - window) * window


class ModelFlops:
    """Model FLOPs of a served model, from its configuration file: two per
    active parameter a token (every matrix a token passes through, the
    head included, the embedding lookup not), plus causal attention over
    the context, each layer over at most its window (QK and PV, two FLOPs a
    multiply-add).  The layers are the family module's
    (``families/<model_type>.py``); the attention terms are summed in
    integers and made a float once."""

    def __init__(self, cfg: dict):
        per_layer = families.load(cfg["model_type"]).layers(cfg)
        self.active_params = (sum(g.params for g in per_layer)
                              + cfg["hidden_size"] * cfg["vocab_size"])
        # {(heads * (qk_dim + v_dim), window): layers}: a few terms a call
        self.attn = Counter((g.heads * (g.qk_dim + g.v_dim), g.window) for g in per_layer)

    def token(self, context: int) -> float:
        """FLOPs of one token attending to ``context`` positions (itself
        included)."""
        attn = sum(n * hw * (min(context, w) if w else context)
                   for (hw, w), n in self.attn.items())
        return 2.0 * self.active_params + float(2 * attn)

    def prefill(self, width: int) -> float:
        """A causal prefill of ``width`` tokens: sum of token(p + 1)."""
        attn = sum(n * hw * _attended(width, w) for (hw, w), n in self.attn.items())
        return 2.0 * self.active_params * width + float(2 * attn)

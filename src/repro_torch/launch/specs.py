"""Stand-ins and step functions for every (arch x shape) cell (the JAX
package's ``launch/specs.py``).

Nothing here allocates: parameters, optimizer state, batches and decode
states are tensors on the meta device (shapes and dtypes only), as the JAX
package's ``jax.eval_shape`` gives ``ShapeDtypeStruct``s.  The dry-run
turns them into fake tensors and places them on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, Segment, ShapeConfig
from repro_torch.models import lm
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import make_train_step

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (a meta tensor)."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------


def params_spec(cfg: ModelConfig):
    return lm.init_params(cfg, device=META)


def opt_spec(cfg: ModelConfig):
    return init_opt_state(params_spec(cfg))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {
        "tokens": sds((B, S), torch.int32),
        "labels": sds((B, S), torch.int32),
    }
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = sds((B, cfg.n_prefix_embeds, cfg.d_model), torch.float32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = sds((B, cfg.encoder_seq, cfg.d_model), torch.float32)
    return out


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = batch_specs(cfg, shape)
    out = {"tokens": b["tokens"]}
    for k in ("prefix_embeds", "enc_embeds"):
        if k in b:
            out[k] = b[k]
    return out


def decode_state_spec(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    return lm.init_decode_state(cfg, B, S, filled=S - 1, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The full stand-in set for one cell (what the dry-run traces with)."""
    if shape.kind == "train":
        return {
            "params": params_spec(cfg),
            "opt_state": opt_spec(cfg),
            "batch": batch_specs(cfg, shape),
        }
    if shape.kind == "prefill":
        return {
            "params": params_spec(cfg),
            "batch": prefill_input_specs(cfg, shape),
        }
    # decode
    return {
        "params": params_spec(cfg),
        "tokens": sds((shape.global_batch,), torch.int32),
        "state": decode_state_spec(cfg, shape),
    }


# ---------------------------------------------------------------------------
# Step functions (what runs per shape kind)
# ---------------------------------------------------------------------------


def make_step_fn(cfg: ModelConfig, shape: ShapeConfig, microbatch: int = 0) -> Callable:
    if shape.kind == "train":
        ts = make_train_step(cfg, microbatch=microbatch)

        def train_step(params, opt_state, batch):
            loss, params, opt_state, stats = ts(params, opt_state, batch)
            return loss, params, opt_state

        return train_step

    if shape.kind == "prefill":
        cache_len = shape.seq_len + cfg.n_prefix_embeds  # prefix shares cache

        def prefill_step(params, batch):
            logits, state = lm.prefill(
                params, cfg, batch["tokens"], max_len=cache_len,
                prefix_embeds=batch.get("prefix_embeds"),
                enc_embeds=batch.get("enc_embeds"),
            )
            return lm.argmax_tokens(logits), state

        return prefill_step

    def serve_step(params, tokens, state):
        logits, state = lm.decode_step(params, cfg, tokens, state)
        return lm.argmax_tokens(logits), state

    return serve_step


# ---------------------------------------------------------------------------
# Depth variants (the JAX dry-run's cost extrapolation; the port traces
# the full depth, and keeps these for configurations cut to size)
# ---------------------------------------------------------------------------


def _seg_type(seg: Segment) -> tuple:
    return (seg.mixer, seg.ffn, seg.cross_attn)


def unique_segment_types(cfg: ModelConfig) -> list[tuple]:
    seen, out = set(), []
    for seg in tuple(cfg.segments) + tuple(cfg.encoder_segments):
        t = _seg_type(seg)
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def depth_variant(cfg: ModelConfig, bump: tuple | None, shape: ShapeConfig) -> ModelConfig:
    """All segments at repeat=1 (bumped type at repeat=2), scans unrolled,
    loss un-chunked."""

    def rep(seg: Segment) -> Segment:
        r = 2 if (bump is not None and _seg_type(seg) == bump) else 1
        return dataclasses.replace(seg, repeat=r)

    segs = tuple(rep(s) for s in cfg.segments)
    enc = tuple(rep(s) for s in cfg.encoder_segments)
    return dataclasses.replace(
        cfg,
        segments=segs,
        n_layers=sum(s.repeat for s in segs),
        encoder_segments=enc,
        n_encoder_layers=sum(s.repeat for s in enc),
        scan_layers=False,
        unroll_scans=True,
        loss_chunk=shape.seq_len,
    )


def layer_multiplier(cfg: ModelConfig, t: tuple) -> int:
    """How many layers of segment-type t the full model has."""
    n = 0
    for seg in tuple(cfg.segments) + tuple(cfg.encoder_segments):
        if _seg_type(seg) == t:
            n += seg.repeat
    return n

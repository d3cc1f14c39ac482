"""Deterministic synthetic token pipeline (train substrate).

A seeded, stateless-per-step stream: batch(step) is a pure function of
(seed, step), so restarts resume exactly from the checkpointed step — the
data-side half of fault tolerance.  ``DataConfig`` and
``SyntheticTokenStream`` are copies of the JAX package's classes (numpy
only, the same bits); ``to_device`` hands a batch to the port's train step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.3  # token distribution skew (realistic unigram stats)


class SyntheticTokenStream:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig | None = None):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg if data_cfg is not None else DataConfig()

    def batch_at(self, step: int, local_batch: int | None = None,
                 batch_offset: int = 0) -> dict:
        B = local_batch or self.shape.global_batch
        S = self.shape.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([self.data_cfg.seed, step, batch_offset])
        )
        # zipf-ish tokens clipped to vocab
        toks = rng.zipf(self.data_cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = np.minimum(toks - 1, self.cfg.vocab_size - 1).astype(np.int32)
        batch = {
            "tokens": toks[:, :S],
            "labels": toks[:, 1 : S + 1],
        }
        if self.cfg.n_prefix_embeds:
            batch["prefix_embeds"] = rng.standard_normal(
                (B, self.cfg.n_prefix_embeds, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        if self.cfg.is_encoder_decoder:
            batch["enc_embeds"] = rng.standard_normal(
                (B, self.cfg.encoder_seq, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        return batch


def to_device(batch: dict, device) -> dict:
    """A ``batch_at`` batch (numpy) as tensors on ``device``: tokens and
    labels keep int32, embeddings f32."""
    return {key: torch.from_numpy(val).to(device) for key, val in batch.items()}

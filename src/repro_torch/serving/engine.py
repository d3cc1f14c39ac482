"""Slab-based continuous-batching generation engine (real execution mode).

The engine owns a fixed pool of ``max_batch`` sequence slots backed by one
decode state (``lm.init_decode_state``), so a decode step is one call over
the whole slab: the step() the wavefront scheduler drives.  Sequences join
via per-sequence prefill (bucketed, left-padded) whose state is copied into
a free slot, and leave when EOS/max-token hits, freeing the slot for the
next request: continuous batching.

This engine is what ``RealBackend`` binds to.  ``step()`` ends in a
``.cpu()`` of the next tokens, which waits for the device, so the time
``RealBackend.gen_duration`` measures around it is the decode's, not the
launches'.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving.sampler import SamplerConfig, sample


@dataclasses.dataclass
class Sequence:
    seq_id: int
    slot: int
    prompt_len: int
    max_new: int
    tokens: list  # generated tokens
    done: bool = False


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


class GenerationEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_len: int = 512, eos_id: int = 0,
                 sampler: Optional[SamplerConfig] = None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.sampler = sampler if sampler is not None else SamplerConfig()
        self.state = lm.init_decode_state(cfg, max_batch, max_len, device=self.device)
        self.free_slots = list(range(max_batch))
        self.seqs: dict[int, Sequence] = {}
        self._next_id = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._last_tokens = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self._active = np.zeros((max_batch,), bool)

    # ------------------------------------------------------------- internals
    def _decode(self, active: torch.Tensor) -> torch.Tensor:
        logits, self.state = lm.decode_step(self.params, self.cfg, self._last_tokens,
                                            self.state)
        nxt = sample(logits, self._gen, self.sampler)
        # frozen slots keep emitting pad; their cache_len must not grow
        cl = self.state["cache_len"]
        self.state["cache_len"] = torch.where(active, cl, cl - 1)
        return nxt

    def _insert(self, one_state: dict, slot: int) -> None:
        """Copy a one-sequence prefill state into slab slot ``slot``."""
        self.state["cache_len"][slot] = one_state["cache_len"][0]
        for slab_seg, one_seg in zip(self.state["segments"], one_state["segments"]):
            for name, slab in slab_seg["mixer"].items():
                slab[:, slot] = one_seg["mixer"][name][:, 0]  # (L, B, ...) <- (L, 1, ...)

    # ------------------------------------------------------------------ API
    def can_admit(self) -> bool:
        return bool(self.free_slots)

    def add_sequence(self, prompt_tokens: np.ndarray, max_new: int = 64) -> int:
        """Prefill a prompt into a free slot; returns seq id."""
        if not self.free_slots:
            raise RuntimeError("no free slots")
        slot = self.free_slots.pop()
        # decode writes land at cache_len, so the padded prompt width plus
        # the decode cap must fit the cache or late steps clamp at max_len
        # and corrupt the last KV slot.  Reserve decode room for max_new
        # (but at most half the cache — max_new is often a loose cap), keep
        # the prompt suffix (left-pad semantics), and shrink the effective
        # max_new to the headroom left after padding.
        decode_room = min(max_new, max(self.max_len // 2, 1))
        keep = max(self.max_len - decode_room, 1)
        prompt_tokens = np.asarray(prompt_tokens)
        if len(prompt_tokens) > keep:
            prompt_tokens = prompt_tokens[-keep:]
        n = len(prompt_tokens)
        pad_to = min(_bucket(n), keep)
        max_new = min(max_new, self.max_len - pad_to)
        toks = np.zeros((1, pad_to), np.int64)
        toks[0, pad_to - n:] = prompt_tokens  # left-pad (simplest causal-safe)
        logits, st1 = lm.prefill(self.params, self.cfg,
                                 torch.from_numpy(toks).to(self.device),
                                 max_len=self.max_len)
        self._insert(st1, slot)
        # note: left-padding slightly pollutes the prefix; acceptable for the
        # integration path (real deployment uses paged prefill)
        first = int(torch.argmax(logits[0]))
        sid = self._next_id
        self._next_id += 1
        self.seqs[sid] = Sequence(sid, slot, n, max_new, [first])
        self._active[slot] = True
        self._last_tokens[slot] = first
        return sid

    def step(self) -> dict[int, int]:
        """One decode step over the slab; returns {seq_id: new_token}."""
        if not self.seqs:
            return {}
        active = torch.from_numpy(self._active.copy()).to(self.device)
        nxt = self._decode(active)
        self._last_tokens = nxt
        out: dict[int, int] = {}
        nxt_np = nxt.cpu().numpy()  # waits for the device (see module docstring)
        for sid, seq in list(self.seqs.items()):
            if seq.done:
                continue
            tok = int(nxt_np[seq.slot])
            seq.tokens.append(tok)
            out[sid] = tok
            if tok == self.eos_id or len(seq.tokens) >= seq.max_new:
                seq.done = True
                self._active[seq.slot] = False
                self.free_slots.append(seq.slot)
                del self.seqs[sid]
        return out

    def step_batch(self, n_steps: int) -> None:
        for _ in range(n_steps):
            if not self.seqs:
                return
            self.step()

    @property
    def batch_size(self) -> int:
        return len(self.seqs)

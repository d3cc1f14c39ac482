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

The step body (``_decode``) is a function of tensors that never move: the
slab's leaves, ``cache_len``, the last and next tokens and the active-slot
mask, each written in place.  On CUDA the engine captures that body once,
at construction, as one CUDA graph, and each ``step()`` copies the mask in
and replays it: one launch a step, the port's form of the JAX engine's
``jax.jit(_decode_impl, donate_argnums=(1,))``.  The capture is preceded
by one eager warm-up step on the capture's stream (it builds the kernels,
allocates their counters and cuBLAS's workspace) and followed by a reset
of every buffer and of the sampler's generator, so a fresh engine starts
from zeros and ``seed``.  A capture or replay that fails raises; the
engine never carries on eagerly on CUDA.  Parameters or state that hold
a DTensor (the mesh paths: ``lm._traversal``, ``layers._sharded_decode``)
are not captured: DTensor's sharding propagation runs on the host at each
op, so the engine runs the same body eagerly for them.  On the CPU the
body runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import lm
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.training.tree import leaves


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
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: the engine passes no "
                             "encoder frames, so it serves decoder-only models")
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
        dev = self.device
        self._last_tokens = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self._next_tokens = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros((max_batch,), dtype=torch.bool, device=dev)
        # the slot bookkeeping writes the mask on the host, in pinned memory
        # on CUDA, from where each step copies it in
        self._active_host = torch.zeros((max_batch,), dtype=torch.bool,
                                        pin_memory=dev.type == "cuda")
        self._active = self._active_host.numpy()
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches = 0  # decode_attention launches a replay makes
        if dev.type == "cuda" and not _holds_dtensor([params, self.state]):
            self._capture(seed)

    # ------------------------------------------------------------- internals
    def _buffers(self) -> list[torch.Tensor]:
        """Every tensor the step body reads or writes besides the params:
        the captured graph's inputs and outputs, at fixed addresses."""
        return [self.state["cache_len"], *leaves(self.state["segments"]), self._last_tokens,
                self._next_tokens, self._active_dev]

    def _decode(self) -> None:
        """The step body: one decode step over the slab, every result written
        in place (the K/V rows and recurrent states into the slab, the
        sampled tokens into ``_next_tokens`` and ``_last_tokens``)."""
        logits, _ = lm.decode_step(self.params, self.cfg, self._last_tokens, self.state)
        self._next_tokens.copy_(sample(logits, self._gen, self.sampler))
        # frozen slots keep emitting pad; their cache_len must not grow
        self.state["cache_len"].add_(self._active_dev)
        self._last_tokens.copy_(self._next_tokens)

    def _capture(self, seed: int) -> None:
        """Warm up, capture ``_decode`` as one CUDA graph, then reset every
        buffer and the generator to their initial values."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            # the kernels' counters allow no concurrent launches: the side
            # stream starts after all work queued on the current one
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._decode()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            if self.sampler.temperature > 0.0:
                graph.register_generator_state(self._gen)  # each replay draws anew
            n0 = decode_attention.launches
            with torch.cuda.graph(graph, stream=side):
                self._decode()
            # recorded, not run: each replay adds them (step())
            self._graph_launches = decode_attention.launches - n0
            decode_attention.launches = n0
            for t in self._buffers():
                t.zero_()
        self._gen.manual_seed(seed)
        self._graph = graph

    def _insert(self, one_state: dict, slot: int) -> None:
        """Copy a one-sequence prefill state into slab slot ``slot``: every
        leaf (K/V rows, int8 scales, latents, recurrent states, enc_kv)."""
        self.state["cache_len"][slot] = one_state["cache_len"][0]

        def ins(slab, one):
            if isinstance(slab, dict):
                for name in slab:
                    ins(slab[name], one[name])
            else:
                slab[:, slot] = one[:, 0]  # (L, B, ...) <- (L, 1, ...)

        for slab_seg, one_seg in zip(self.state["segments"], one_state["segments"]):
            ins(slab_seg, one_seg)

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
        self._active_dev.copy_(self._active_host, non_blocking=True)
        if self._graph is not None:
            self._graph.replay()
            decode_attention.launches += self._graph_launches
        else:
            self._decode()
        out: dict[int, int] = {}
        nxt_np = self._next_tokens.cpu().numpy()  # waits for the device (module docstring)
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


def _holds_dtensor(tree) -> bool:
    return any(isinstance(t, DTensor) for t in leaves(tree))

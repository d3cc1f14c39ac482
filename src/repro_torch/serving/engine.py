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

Two bodies do the work, each a function of tensors that never move.  The
step body (``_decode``) reads and writes the slab's leaves, ``cache_len``,
the last and next tokens and the active-slot mask.  The admission body
(``_prefill``) prefills one padded prompt from a fixed token buffer and
writes its state into the slab at a slot held in a one-element tensor,
every leaf with ``index_copy_``, its length into ``cache_len`` and its
greedy first token into a fixed buffer and into the last tokens.  Each
padded width ``pad_to`` has its own buffers: ``pad_to`` is the prompt's
bucket (32 ... 2048) clipped to what the cache keeps after the decode
room (``keep``, from ``max_new``), so a width can be any number up to
``max_len`` (504 for a 300-token prompt with 8 new tokens in a 512-row
cache), as the JAX engine's jitted prefill is traced once for each shape.

On CUDA each body becomes a CUDA graph, captured after one eager warm-up
run on the capture's stream (it builds cuBLAS's workspace and the
kernels' counters): the step once, at construction, followed by a reset of
every buffer and of the sampler's generator, so a fresh engine starts from
zeros and ``seed``; the admission once for each width, at that width's
first admission, whose warm-up is the real prefill (nothing is reset).
Each ``step()`` copies the mask in and replays its graph; each later
admission at a width copies the prompt and the slot in from pinned host
memory and replays that width's graph.  These are the port's form of the
JAX engine's ``jax.jit(_decode_impl, donate_argnums=(1,))`` and of its
jitted ``_prefill`` with the donated ``_insert``; inside each graph the
model body's norms, qk-norm + RoPE + cache write and gated activations are
the fused kernels ``kernels.norm``, ``qk_rope`` and ``glu`` (the JAX jit's
fusions).  A capture counts every kernel launch it records, and each
replay adds those counts to the wrappers' (the replay itself runs no
Python).  The prefill graphs
share one memory pool: none of their results lives in it (the slab and
the buffers are allocated outside every graph) and they never run at
once.  A capture or replay that fails raises; the engine never carries
on eagerly on CUDA.  Parameters or state that hold a DTensor (the mesh
paths: ``lm._traversal``, ``layers._sharded_decode``) are not captured:
DTensor's sharding propagation runs on the host at each op, so the
engine runs the same bodies eagerly for them.  On the CPU the bodies run
eagerly.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import wrappers
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


@dataclasses.dataclass
class _PrefillBuffers:
    """One padded width's admission buffers at fixed addresses: the left-
    padded prompt, the slot and the first token on the device (the width's
    graph's inputs and output), the prompt and the slot in (pinned) host
    memory, from where each admission copies them in, and the graph once
    captured."""
    tokens: torch.Tensor  # (1, pad_to) int64
    slot: torch.Tensor  # (1,) int64
    first: torch.Tensor  # (1,) int32
    tokens_host: torch.Tensor
    slot_host: torch.Tensor
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: dict = dataclasses.field(default_factory=dict)  # kernel launches a replay makes


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
        self._graph_launches: dict[str, int] = {}  # kernel launches a replay makes, by name
        self._kernels = wrappers()
        # the admission buffers of each padded width, with its graph once
        # captured; all prefill graphs allocate from one pool of their own
        self._prefills: dict[int, _PrefillBuffers] = {}
        self._capture_prefills = False
        if dev.type == "cuda" and not _holds_dtensor([params, self.state]):
            self._stream = torch.cuda.Stream(dev)  # every capture's, so one cuBLAS workspace
            self._prefill_pool = torch.cuda.graph_pool_handle()
            self._graph, self._graph_launches = self._capture(self._decode, self._gen)
            for t in self._buffers():
                t.zero_()
            self._gen.manual_seed(seed)
            self._capture_prefills = True

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

    def _prefill(self, buf: _PrefillBuffers) -> None:
        """The admission body: prefill ``buf.tokens`` and write the one-
        sequence state into the slab at slot ``buf.slot``: every leaf (K/V
        rows, int8 scales, latents, recurrent states) along the slot axis,
        the length into ``cache_len``, the greedy first token (the first
        maximal index) into ``buf.first`` and ``_last_tokens``.  The slot
        is a tensor, so no Python number of it reaches a kernel, and
        nothing here waits for the device."""
        logits, one = lm.prefill(self.params, self.cfg, buf.tokens, max_len=self.max_len)
        self.state["cache_len"].index_copy_(0, buf.slot, one["cache_len"])
        for slab, new in zip(leaves(self.state["segments"]), leaves(one["segments"]),
                             strict=True):
            slab.index_copy_(1, buf.slot, new.to(slab.dtype))  # (L, B, ...) <- (L, 1, ...)
        buf.first.copy_(torch.argmax(logits, -1))
        self._last_tokens.index_copy_(0, buf.slot, buf.first)

    def _prefill_buffers(self, pad_to: int) -> _PrefillBuffers:
        buf = self._prefills.get(pad_to)
        if buf is None:
            dev, pin = self.device, self.device.type == "cuda"
            buf = _PrefillBuffers(
                tokens=torch.zeros((1, pad_to), dtype=torch.int64, device=dev),
                slot=torch.zeros((1,), dtype=torch.int64, device=dev),
                first=torch.zeros((1,), dtype=torch.int32, device=dev),
                tokens_host=torch.zeros((1, pad_to), dtype=torch.int64, pin_memory=pin),
                slot_host=torch.zeros((1,), dtype=torch.int64, pin_memory=pin))
            self._prefills[pad_to] = buf
        return buf

    def _capture(self, body, generator=None, pool=None):
        """Run ``body`` once eagerly on the capture stream (the warm-up: its
        results are real, and it builds what a capture cannot, such as
        qk_rope's frequency table), then capture it as one CUDA graph.
        Returns the graph and the launches it recorded of each kernel, which
        ``_replay`` adds at each replay (the capture ran nothing)."""
        dev, side = self.device, self._stream
        with torch.cuda.device(dev):
            # the kernels' counters allow no concurrent launches: the side
            # stream starts after all work queued on the current one
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            if generator is not None and self.sampler.temperature > 0.0:
                graph.register_generator_state(generator)  # each replay draws anew
            n0 = {name: fn.launches for name, fn in self._kernels.items()}
            # a prefill is captured mid-serving: other threads (the wall-
            # clock ingress's) may call into CUDA, and a garbage collection
            # could destroy another engine's graph, which invalidates any
            # capture (torch.cuda.graph collects once before it begins)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    body()
            finally:
                if collecting:
                    gc.enable()
            launches = {name: fn.launches - n0[name] for name, fn in self._kernels.items()
                        if fn.launches != n0[name]}
            for name, fn in self._kernels.items():
                fn.launches = n0[name]
        return graph, launches

    def _replay(self, graph: torch.cuda.CUDAGraph, launches: dict) -> None:
        graph.replay()
        for name, n in launches.items():
            self._kernels[name].launches += n

    def _admit(self, tokens: np.ndarray, slot: int) -> int:
        """Prefill the left-padded prompt ``tokens`` (pad_to,) into slab slot
        ``slot`` through its width's buffers: replay the width's graph, or
        at its first admission on CUDA run the body and capture it, or (CPU,
        DTensors) run the body.  Returns the first token."""
        buf = self._prefill_buffers(len(tokens))
        buf.tokens_host.numpy()[0] = tokens
        buf.slot_host[0] = slot
        buf.tokens.copy_(buf.tokens_host, non_blocking=True)
        buf.slot.copy_(buf.slot_host, non_blocking=True)
        if buf.graph is not None:
            self._replay(buf.graph, buf.launches)
        elif self._capture_prefills:
            buf.graph, buf.launches = self._capture(lambda: self._prefill(buf),
                                                    pool=self._prefill_pool)
        else:
            self._prefill(buf)
        return int(buf.first.cpu()[0])  # waits for the device, as JAX's int(argmax)

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
        toks = np.zeros((pad_to,), np.int64)
        toks[pad_to - n:] = prompt_tokens  # left-pad (simplest causal-safe)
        # note: left-padding slightly pollutes the prefix; acceptable for the
        # integration path (real deployment uses paged prefill)
        first = self._admit(toks, slot)
        sid = self._next_id
        self._next_id += 1
        self.seqs[sid] = Sequence(sid, slot, n, max_new, [first])
        self._active[slot] = True
        return sid

    def step(self) -> dict[int, int]:
        """One decode step over the slab; returns {seq_id: new_token}."""
        if not self.seqs:
            return {}
        self._active_dev.copy_(self._active_host, non_blocking=True)
        if self._graph is not None:
            self._replay(self._graph, self._graph_launches)
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

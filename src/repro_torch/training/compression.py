"""Gradient compression for the cross-pod reduction, and its host-path
relative ``block_saliency`` (the JAX package's ``training/compression.py``).

The inter-pod hop quantizes each gradient leaf to int8 blocks with a
per-block absmax f32 scale, all-gathers codes and scales over a
``torch.distributed`` process group (the JAX ``all_gather`` over a mesh
axis inside ``shard_map``) and sums the dequantized parts; the error each
rank's quantisation leaves is fed into its next step's gradient
(``ErrorFeedback``).  ``torch.round`` rounds half to even, as ``jnp.round``
does, so the codes are the JAX package's bit for bit.  A gloo group moves
CUDA tensors through the host; NCCL keeps them on the cards.

``block_saliency`` is a copy of the JAX function: pure numpy, it ranks
candidate documents for the extractive-compression serving stage
(``core/stages.py`` ``CompressSpec``, through ``compression_scores``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.training.tree import leaves, tree_map, unflatten

f32 = torch.float32


def _quantize_blocks(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    flat = x.to(f32).reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    # a divisor on the tensor's device: CUDA divides by a Python scalar as a
    # product with its reciprocal, which can round the scale one ulp away
    # from the CPU's (and JAX's) quotient
    scale = torch.clamp(blocks.abs().amax(dim=1), min=1e-12) / torch.full((), 127.0,
                                                                          device=x.device)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale, pad


def _dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, pad: int, shape) -> torch.Tensor:
    flat = (q.to(f32) * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum_leaf(x: torch.Tensor, group=None, block: int = 256) -> torch.Tensor:
    """int8 all-gather-sum of ``x`` over ``group`` (the default group when
    None): every rank returns the sum over ranks of its dequantized codes,
    in ``x``'s dtype."""
    q, scale, pad = _quantize_blocks(x, block)
    world = dist.get_world_size(group)
    q_all = [torch.empty_like(q) for _ in range(world)]
    s_all = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(q_all, q, group=group)        # (n, blocks, block) int8
    dist.all_gather(s_all, scale, group=group)    # (n, blocks) f32
    deq = torch.stack(q_all).to(f32) * torch.stack(s_all)[..., None]
    total = deq.sum(dim=0).reshape(-1)
    if pad:
        total = total[:-pad]
    return total.reshape(x.shape).to(x.dtype)


def quantization_residual(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """x - dequant(quant(x)): the error-feedback term."""
    q, scale, pad = _quantize_blocks(x, block)
    return (x.to(f32) - _dequantize_blocks(q, scale, pad, x.shape)).to(x.dtype)


def block_saliency(x, block: int = 256):
    """Per-row information-density proxy reusing the per-block absmax scale
    rule of ``_quantize_blocks``: mean over each row's blocks of the absmax
    scale a quantizer would assign.  Rows whose feature blocks carry larger
    dynamic range compress worse — i.e. hold more information — which is
    what the extractive-compression serving stage (core/stages.py
    CompressSpec) ranks candidates by.  Pure numpy on purpose: it runs on
    the serving host path, not under jit."""
    import numpy as np

    v = np.asarray(x, np.float32)
    v = v.reshape(1, -1) if v.ndim == 1 else v
    n, d = v.shape
    pad = (-d) % block
    if pad:
        v = np.concatenate([v, np.zeros((n, pad), np.float32)], axis=1)
    blocks = v.reshape(n, -1, block)
    scale = np.maximum(np.abs(blocks).max(axis=2), 1e-12) / 127.0
    return scale.mean(axis=1)


class ErrorFeedback:
    """Residual accumulator: grads_in + residual -> compress -> new residual."""

    @staticmethod
    def init(grads):
        return tree_map(lambda g: torch.zeros(g.shape, dtype=f32, device=g.device), grads)

    @staticmethod
    def apply(grads, ef_state, block: int = 256):
        """Returns (grads_to_send, new_ef_state); the inputs are unchanged."""
        def one(g, e):
            corrected = g.to(f32) + e
            resid = quantization_residual(corrected, block)
            return (corrected - resid).to(g.dtype), resid

        pairs = [one(g, e) for g, e in zip(leaves(grads), leaves(ef_state))]
        return (unflatten(grads, [p[0] for p in pairs]),
                unflatten(grads, [p[1] for p in pairs]))


def dcn_bytes_saved(n_params: int, n_pods: int = 2) -> dict:
    """Napkin report: bf16 all-reduce vs int8 all-gather over the pod axis."""
    ar = 2 * 2 * n_params * (n_pods - 1) / n_pods  # ring AR, bf16
    ag = (1 + 4 / 256) * n_params * (n_pods - 1)   # int8 + scales, AG
    return {"bf16_allreduce_bytes": ar, "int8_allgather_bytes": ag,
            "saving": ar / ag}

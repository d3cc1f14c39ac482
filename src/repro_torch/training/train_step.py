"""The training step (loss -> grads -> AdamW), microbatch-capable (the JAX
package's ``training/train_step.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.training.tree import leaves, unflatten


def value_and_grad(cfg: ModelConfig, params, batch: dict):
    """(loss, grads): the loss of ``lm.train_loss`` and its gradient with
    respect to every parameter leaf, as a tree shaped as ``params`` (leaves
    in the parameters' dtypes).  ``params`` themselves are not marked as
    requiring grad: the step differentiates detached aliases of them.

    On DTensor parameters (under a mesh) each gradient is laid out as its
    parameter (the partial sums reduced and scattered) and the loss is
    replicated."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = lm.train_loss(unflatten(params, flat), cfg, batch)
        grads = torch.autograd.grad(loss, flat)
    grads = [_laid_out_as(g, p) for g, p in zip(grads, flat)]
    return _laid_out_as(loss.detach(), None), unflatten(params, grads)


def _laid_out_as(t, like):
    """A DTensor ``t`` redistributed to ``like``'s placements (replicated
    when ``like`` is None); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    pl = like.placements if like is not None else [Replicate()] * t.device_mesh.ndim
    return t if tuple(t.placements) == tuple(pl) else t.redistribute(t.device_mesh, pl)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[OptConfig] = None,
                    microbatch: int = 0):
    """Returns train_step(params, opt_state, batch) -> (loss, params,
    opt_state, stats); ``params`` and ``opt_state`` are updated in place and
    returned (``adamw_update``).

    ``microbatch`` > 1 splits the batch's leading axis into that many equal
    slices run one after another, accumulating the gradients in f32 (so they
    reach the optimizer in f32, as in the JAX package), and returns the mean
    loss and mean gradient: activation memory drops by that factor.
    """
    opt_cfg = opt_cfg or OptConfig()

    def grads_of(params, batch):
        if not microbatch or microbatch <= 1:
            return value_and_grad(cfg, params, batch)
        acc_loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
        acc_g = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
        n = batch["tokens"].shape[0] // microbatch
        for i in range(microbatch):
            part = {key: x[i * n:(i + 1) * n] for key, x in batch.items()}
            loss, g = value_and_grad(cfg, params, part)
            for a, gi in zip(acc_g, leaves(g)):
                a.add_(gi)
            acc_loss = acc_loss + loss
        inv = 1.0 / microbatch
        return acc_loss * inv, unflatten(params, [a * inv for a in acc_g])

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        params, opt_state, stats = adamw_update(opt_cfg, params, grads, opt_state)
        return loss, params, opt_state, stats

    return train_step

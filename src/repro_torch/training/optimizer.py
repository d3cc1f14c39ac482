"""AdamW with global-norm clipping and a warmup-cosine schedule (the JAX
package's ``training/optimizer.py``).

The arithmetic is the JAX package's: the update is computed in f32 and cast
back to the parameter's dtype (there is no f32 master copy), the step count
is advanced before the schedule reads it, bias correction is in f32, and
``global_norm`` adds the leaves in JAX's flatten order.  Everything stays on
the parameters' device: no value is read back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.training.tree import leaves, tree_map

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_opt_state(params) -> dict:
    """f32 zeros ``mu`` and ``nu`` shaped as ``params``, and an int32 step,
    on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=f32, device=p.device)  # noqa: E731
    device = leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine decay
    to ``min_lr_frac`` of ``lr`` at ``total_steps``; f32."""
    step = step.to(f32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(f32)))
    return torch.sqrt(total)


def adamw_update(cfg: OptConfig, params, grads, opt_state):
    """Returns (params, opt_state, stats), the first two updated in place:
    the results are written into the given tensors, as the JAX launcher
    donates both buffers to its jitted step."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = schedule(cfg, step)
        b1, b2 = cfg.betas
        bc1 = 1.0 - b1 ** step.to(f32)
        bc2 = 1.0 - b2 ** step.to(f32)
        for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(opt_state["mu"]),
                                leaves(opt_state["nu"])):
            g = g.to(f32) * scale
            mu2 = b1 * mu + (1 - b1) * g
            nu2 = b2 * nu + (1 - b2) * g * g
            mhat = mu2 / bc1
            nhat = nu2 / bc2
            delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p.to(f32)
            p.copy_((p.to(f32) - lr * delta).to(p.dtype))
            mu.copy_(mu2)
            nu.copy_(nu2)
        opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}

"""Convert the JAX package's parameter pytree (and its AdamW state) into
the port's.

The port keeps the JAX layout, so no tensor is transposed: every weight is
``(in, out)`` and applied as ``x @ W``, the tied head is ``embed.T``, and a
segment's layers stay stacked on a leading layer axis.  Only containers
change (tuples become lists) and arrays become tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """``tree``: the JAX params pytree with numpy (or array-like) leaves, e.g.
    ``jax.tree.map(np.asarray, lm.init_params(cfg, key))``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(val) for val in node]
        return _tensor(node, dev)

    params = conv(tree)
    if len(params["segments"]) != len(cfg.segments):
        raise ValueError("params and config disagree on the number of segments")
    return params


def opt_state_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """``tree``: the JAX package's AdamW state ``{"mu", "nu", "step"}`` with
    numpy (or array-like) leaves, e.g. ``jax.tree.map(np.asarray, opt)``: f32
    moments shaped as the parameters and the int32 step."""
    dev = resolve_device(device)
    return {"mu": params_from_numpy(tree["mu"], cfg, dev),
            "nu": params_from_numpy(tree["nu"], cfg, dev),
            "step": _tensor(tree["step"], dev)}

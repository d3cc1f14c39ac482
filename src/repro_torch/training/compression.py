"""Compression on the serving host path.

``block_saliency`` is a copy of the function of the same name in the JAX
package's ``training/compression.py``: pure numpy, it ranks candidate
documents for the extractive-compression stage (``core/stages.py``
``CompressSpec``, through ``compression_scores``).  The rest of that file,
the int8 gradient compression of the cross-pod reduction, waits for the
port of training (ROADMAP.md queue A item 6).
"""
from __future__ import annotations


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

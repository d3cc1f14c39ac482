"""A private switch for comparisons on the card: under ``plain_on_card()``
the fused ops ``norm``, ``qk_rope`` and ``glu`` take their plain versions on
CUDA tensors too (and count them in ``plain_calls``).

It exists so that a test or ``chip_smoke.py`` can hold a path through the
kernels against the same path through the plain chains on one card, as the
wrappers' private ``_chunk=`` forces a split.  No module of the package
enters it (``tests/test_torch_fused.py`` checks).  It is process-wide, not
per thread: a CUDA graph captured under it records the plain chains.
"""
from __future__ import annotations

import contextlib

_depth = 0


@contextlib.contextmanager
def plain_on_card():
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def active() -> bool:
    return _depth > 0

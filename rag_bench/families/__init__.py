"""What the harness knows of a model family, one module a family
(``<model_type>.py``), found by the configuration file's ``model_type`` as
``reference/<model_type>.py`` is.  A family enters the benchmark as new
files only: its configuration, its reference, its module here, its cells.

Each module defines:

* ``port(f)``: {``ModelConfig`` attribute: value} that the configuration
  file ``f`` fixes, ``segments`` as a tuple of (mixer, ffn, repeat)
  tuples; it raises ``ValueError`` where the file states what the port
  cannot run.
* ``TINY``: the overrides of ``ModelConfig.reduced`` at the tiny size.
* ``tiny_view(mc)``: the file's keys that take the port's own widths at the
  tiny size, {file key: value}.
* ``layers(f)``: one ``harness.peaks.Layer`` a layer, for ``ModelFlops``.
* ``WEIGHTS``: {leaf name: rule} for leaves that ``harness.weights``'s own
  rules do not cover (``"norm"``, ``"zero"`` or ``"small"``).

Like ``reference/``, a family module imports neither ``jax``, nor the JAX
package, nor ``repro_torch``: it reads the port's config only as an object
it is handed.
"""
from __future__ import annotations

import importlib


def load(model_type: str):
    """The family module of ``model_type``; ``ValueError`` where there is none."""
    name = f"rag_bench.families.{model_type}"
    missing = ValueError(f"no family module for model_type {model_type!r}: "
                         f"rag_bench/families/{model_type}.py is missing")
    if not model_type.isidentifier():
        raise missing
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise missing from None

"""The benchmark's own tests: ``python -m pytest rag_bench/tests`` from the
repository's root (the repository's test run collects ``tests/`` only).
Tests marked ``cuda`` need a card and skip without one; the rest run on the
CPU at tiny sizes, through the kernels' plain versions."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, not at
    import: every worker must collect the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def cells() -> list:
    """The names of BENCHMARK.json's cells."""
    import json

    return [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny_run(cell: str, seed: int = 90210, seconds: float = 3.0, trace: bool = False, **kw):
    """One run of ``cell`` at the tiny size on the CPU."""
    import torch

    from rag_bench import run

    return run.run_cell(torch, torch.device("cpu"), run.load_spec(cell), seed, seconds, trace,
                        tiny=True, out=lambda *a: None, **kw)

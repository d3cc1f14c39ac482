"""Nothing under rag_bench imports jax, jaxlib, flax or the JAX package
``repro``, and the reference and the family modules import nothing of the
port either.  Names
are compared whole, by the part before the first dot: ``repro_torch`` is
not ``repro``."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "rag_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    got = top_level_imports(path)
    assert not got & FORBIDDEN, f"{path} imports {got & FORBIDDEN}"
    if path.parent.name in ("reference", "families"):
        assert "repro_torch" not in got


def test_whole_name_comparison():
    from rag_bench.run import forbidden_modules

    assert forbidden_modules(["repro_torch", "repro_torch.models.lm", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["repro_torch", "repro.core.wavefront"]) == ["repro"]
    assert forbidden_modules(["jaxlib.xla_client", "flax", "jax"]) == ["flax", "jax", "jaxlib"]


def test_a_run_loads_none_of_them():
    """A tiny run in a fresh process with jax, jaxlib, flax and repro made
    unimportable, which then finds none of them loaded."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'repro'): sys.modules[m] = None\n"
        # the benchmark's conftest ahead of the repository's own at the root
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from conftest import tiny_run\n"
        "r = tiny_run('qwen3-rag-qa-online', seconds=2.0)\n"
        "for m in ('jax', 'jaxlib', 'flax', 'repro'): del sys.modules[m]\n"
        "from rag_bench.run import forbidden_modules\n"
        "assert r['result']['correct'], r['result']\n"
        "assert forbidden_modules() == [], forbidden_modules()\n"
        "print('clean')\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0 and "clean" in p.stdout, p.stderr[-3000:]


def test_the_reference_runs_without_the_port():
    """Every module under ``reference/`` and ``families/`` imports with jax,
    the JAX package and the port made unimportable."""
    mods = [f"rag_bench.{p.parent.name}.{p.stem}" for d in ("reference", "families")
            for p in sorted((BENCH / d).glob("*.py")) if p.stem != "__init__"]
    assert {"rag_bench.reference.qwen3", "rag_bench.families.deepseek_v2"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'repro', 'repro_torch'): sys.modules[m] = None\n"
        f"sys.path[:0] = [{str(ROOT)!r}]\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('clean')\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "clean" in p.stdout, p.stderr[-3000:]

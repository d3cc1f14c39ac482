"""The port stands alone: it imports neither JAX nor the JAX package, its
verbatim copies equal their sources, and its entry points never fall back
to the CPU unasked."""
import ast
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _support import run

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

# modules the port keeps as copies of numpy-only modules of the JAX package
COPIES = sorted(
    [p.relative_to(SRC / "repro").as_posix() for p in (SRC / "repro" / "configs").glob("*.py")]
    + [f"core/{m}.py" for m in ("ownership", "ragraph", "runtime", "similarity",
                                "speculation", "substage", "transforms", "stages",
                                "wavefront", "backends")]
    + [f"retrieval/{m}.py" for m in ("plan", "hotcache", "synthetic", "lexical")]
    + [f"serving/{m}.py" for m in ("dispatch", "faults", "lifecycle", "workload", "ingress")]
    + [f"obs/{m}.py" for m in ("__init__", "trace", "attribution", "registry")]
    + [f"crossreq/{m}.py" for m in ("__init__", "popularity", "globalcache", "dedup")]
    + ["server.py", "workflows.py", "analysis/memory_model.py"]
)
# repro-lint: copies under a wider rename, which also covers its policy's
# zone prefixes (``repro/core/``) and its CLI's bare ``import repro``
LINT_COPIES = sorted(p.relative_to(SRC / "repro").as_posix()
                     for p in (SRC / "repro" / "analysis" / "lint").glob("*.py"))
# modules that a port import names but the port lacks: none
NOT_PORTED: set = set()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_repro_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def _rename(text: str) -> str:
    return re.sub(r"\brepro(?=\.|\s+import\b)", "repro_torch", text)


def _rename_lint(text: str) -> str:
    return re.sub(r"\brepro(?=[./]|\s+import\b|\s*$)", "repro_torch", text, flags=re.M)


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_their_sources(rel):
    src = (SRC / "repro" / rel).read_text()  # read as text, never imported
    assert (PORT / rel).read_text() == _rename(src)


@pytest.mark.parametrize("rel", LINT_COPIES)
def test_lint_copies_equal_their_sources(rel):
    src = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == _rename_lint(src)


def test_lint_copy_is_complete():
    assert len(LINT_COPIES) == 8
    assert sorted(p.relative_to(PORT).as_posix()
                  for p in (PORT / "analysis" / "lint").glob("*.py")) == LINT_COPIES


def _segment(path: Path, name: str) -> str:
    text = path.read_text()
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)) and node.name == name:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"{path.name} defines no {name}")


@pytest.mark.parametrize("name", ["ShardMap", "scatter_gather_search"])
def test_distributed_numpy_parts_equal_their_sources(name):
    """``retrieval/distributed.py`` rewrites the JAX search in torch but keeps
    the serving path's numpy side as a copy."""
    rel = Path("retrieval") / "distributed.py"
    assert _segment(PORT / rel, name) == _rename(_segment(SRC / "repro" / rel, name))


@pytest.mark.parametrize("name", ["DataConfig", "SyntheticTokenStream"])
def test_data_stream_equals_its_source(name):
    """``training/data.py`` keeps the JAX package's numpy stream as a copy
    (the same bits for a step) and drops its unused JAX imports."""
    rel = Path("training") / "data.py"
    assert _segment(PORT / rel, name) == _rename(_segment(SRC / "repro" / rel, name))


def test_block_saliency_equals_its_source():
    """``training/compression.py`` keeps only the serving host path's
    ``block_saliency``, a copy of the JAX package's function."""
    rel = Path("training") / "compression.py"
    seg = _rename(_segment(SRC / "repro" / rel, "block_saliency"))
    assert _segment(PORT / rel, "block_saliency") == seg


def _module_exists(name: str) -> bool:
    path = SRC.joinpath(*name.split("."))
    return path.with_suffix(".py").is_file() or (path / "__init__.py").is_file()


def test_every_port_import_target_exists():
    """Every ``repro_torch.*`` module an import of the port names, lazy
    imports inside functions included, exists in the port."""
    missing = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                # ``from pkg import mod`` names a module when mod is one
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names
                                         if _module_exists(f"{node.module}.{a.name}")]
            else:
                continue
            missing += [f"{path.relative_to(PORT)}: {n}" for n in names
                        if n.split(".")[0] == "repro_torch" and not _module_exists(n)
                        and n not in NOT_PORTED]
    assert not missing, missing


def test_port_runs_with_jax_and_repro_blocked(tmp_path):
    """... and trains without msgpack or ml_dtypes, which the card's machine
    lacks (the JAX checkpoint writes msgpack and bf16 through ml_dtypes)."""
    code = (
        "import sys\n"
        "for name in ('jax', 'repro', 'msgpack', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "import repro_torch.obs, repro_torch.crossreq, repro_torch.serving.ingress\n"
        "import repro_torch.examples.serve_rag_e2e, repro_torch.examples.train_lm\n"
        "import repro_torch.training.compression, repro_torch.training.checkpoint\n"
        "from repro_torch.launch import serve, train\n"
        "from repro_torch.kernels.ivf_scan import ivf_scan\n"
        "m = serve.main(['--device', 'cpu', '--n-requests', '4', '--max-new', '4',\n"
        "                '--workflow', 'irg', '--cache-update-interval', '1',\n"
        "                '--cache-transit', '0', '--arrival-gap-ms', '1000'])\n"
        "assert m.finished == 4 and ivf_scan.plain_calls > 0\n"
        "for args in (['--steps', '2', '--save-every', '1'], ['--steps', '3']):\n"
        "    out = train.main(['--arch', 'qwen3-1.7b', '--reduced', '--device', 'cpu',\n"
        "                      '--ckpt-dir', 'ckpt', *args])\n"
        "assert out['start'] == 2 and list(out['losses']) == [2]\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro', 'msgpack', 'ml_dtypes')\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ISOLATED-OK')\n"
    )
    [r] = run([sys.executable, "-c", code], cwd=tmp_path,
              env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_rag_e2e, train_lm
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.models.convert import opt_state_from_numpy
    from repro_torch.training.checkpoint import restore_checkpoint
    from repro_torch.retrieval import HybridRetrievalEngine, IVFIndex
    from repro_torch.serving.engine import GenerationEngine

    cfg = get_config("qwen3-1.7b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    docs = rng.standard_normal((200, 8)).astype(np.float32)
    index = IVFIndex.build(docs, 4, iters=2, device="cpu")
    for make in (lambda: GenerationEngine(cfg, params),
                 lambda: HybridRetrievalEngine(index, cache_capacity=2),
                 lambda: IVFIndex.build(docs, 4, iters=2),
                 lambda: lm.init_params(cfg),
                 lambda: serve.main(["--n-requests", "1"]),
                 lambda: serve.main(["--wallclock", "--replay-check", "--n-requests", "1"]),
                 lambda: serve_rag_e2e.main(["--smoke", "--crossreq"]),
                 lambda: train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"]),
                 lambda: train_lm.main(["--steps", "1"]),
                 lambda: restore_checkpoint("no-such-dir"),
                 lambda: opt_state_from_numpy({"mu": {}, "nu": {}, "step": 0}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

"""The port stands alone: it imports neither JAX nor the JAX package, its
verbatim copies equal their sources, and its entry points never fall back
to the CPU unasked."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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
    + [f"serving/{m}.py" for m in ("dispatch", "lifecycle", "workload")]
    + ["server.py", "workflows.py"]
)


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


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_their_sources(rel):
    src = (SRC / "repro" / rel).read_text()  # read as text, never imported
    expected = re.sub(r"\brepro(?=\.|\s+import\b)", "repro_torch", src)
    assert (PORT / rel).read_text() == expected


def test_port_runs_with_jax_and_repro_blocked(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.kernels.ivf_scan import ivf_scan\n"
        "m = serve.main(['--device', 'cpu', '--n-requests', '4', '--max-new', '4',\n"
        "                '--workflow', 'irg', '--cache-update-interval', '1',\n"
        "                '--cache-transit', '0', '--arrival-gap-ms', '1000'])\n"
        "assert m.finished == 4 and ivf_scan.plain_calls > 0\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) for k in sys.modules\n"
        "               if sys.modules[k] is not None)\n"
        "print('ISOLATED-OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                                                   "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
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
                 lambda: serve.main(["--n-requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

"""The port's SimBackend examples against the JAX package's: the same
corpus, workflows, arrival stream and sim-time charges give the same
timeline (every printed metric and sample, character for character).

Both examples build their IVF index by k-means, which the two packages
draw differently; each test builds the JAX index once and hands it to both
(the port's as a copy of its arrays), so the timelines meet on one index.
"""
import importlib.util
from pathlib import Path

import pytest

from repro.retrieval.ivf import IVFIndex as JaxIVF
from repro_torch.examples import multi_workflow_concurrent as port_multi
from repro_torch.examples import quickstart as port_quick
from repro_torch.retrieval.ivf import IVFIndex as PortIVF

ROOT = Path(__file__).resolve().parents[1]


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_index(jidx) -> PortIVF:
    return PortIVF(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                   ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)


def _run_both(monkeypatch, capsys, name, port_mod):
    jax_mod = _jax_example(name)
    built, build = {}, JaxIVF.build

    def jax_build(docs, n_clusters, iters=5, **kw):
        built["index"] = build(docs, n_clusters, iters=iters)
        return built["index"]

    monkeypatch.setattr(jax_mod.IVFIndex, "build", staticmethod(jax_build))
    jax_mod.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(port_mod.IVFIndex, "build",
                        staticmethod(lambda *a, **kw: _port_index(built["index"])))
    got_summary = port_mod.main(["--device", "cpu"])
    got = capsys.readouterr().out
    return want, got, got_summary


def test_quickstart_timeline_equals_jax(monkeypatch, capsys):
    want, got, summary = _run_both(monkeypatch, capsys, "quickstart", port_quick)
    assert got == want
    assert summary["finished"] == 24


def test_multi_workflow_concurrent_timeline_equals_jax(monkeypatch, capsys):
    want, got, out = _run_both(monkeypatch, capsys, "multi_workflow_concurrent", port_multi)
    assert got == want
    assert set(out) == {"async", "hedra"} and out["hedra"]["submitted"] == 60


@pytest.mark.parametrize("name", ["quickstart", "multi_workflow_concurrent"])
def test_example_refuses_cuda_without_a_card(name, monkeypatch):
    """Entry points run on the card unless asked for the CPU: without one
    they raise instead of carrying on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"quickstart": port_quick, "multi_workflow_concurrent": port_multi}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_new_modules_run_with_jax_and_repro_blocked(tmp_path):
    """The examples, the sharding rules, the dry-run and its scripts import
    and run with ``jax`` and ``repro`` blocked."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for name in ('jax', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.specs, repro_torch.launch.mesh\n"
        "import repro_torch.analysis.costs, repro_torch.analysis.memory_model\n"
        "import repro_torch.distributed.sharding, repro_torch.distributed.act_sharding\n"
        "import repro_torch.scripts.run_dryrun_all, repro_torch.scripts.inspect_collectives\n"
        "import repro_torch.scripts.build_roofline_report\n"
        "from repro_torch.examples import quickstart, multi_workflow_concurrent\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import specs\n"
        "from repro_torch.distributed import sharding\n"
        "class M:\n"
        "    shape = {'data': 32, 'model': 8}\n"
        "    axis_names = ('data', 'model')\n"
        "cfg = get_config('qwen3-1.7b')\n"
        "assert sharding.param_specs(cfg, M(), specs.params_spec(cfg))['embed'] == "
        "('model', 'data')\n"
        "assert quickstart.main(['--device', 'cpu'])['finished'] == 24\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro')\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ISOLATED-OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout

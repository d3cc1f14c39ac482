"""The port's copies of the two root scripts that import the JAX package
(``scripts/make_golden_fingerprints.py``, ``scripts/export_trace.py``)
against those scripts, computed live in this process.

The JAX scripts are loaded by path; the fingerprint script's ``fixture``
builds the JAX index (JAX k-means), and the port's scripts serve over an
``IVFIndex`` built from its numpy fields, since k-means draws its initial
centroids from ``jax.random``.  The JAX script's ``main`` is never called
(it writes ``tests/golden_fingerprints.json``); the trace script's writes
only where it is told.
"""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")

from repro import workflows as jax_workflows  # noqa: E402
from repro.core.backends import SimBackend as JaxSimBackend  # noqa: E402
from repro.server import Server as JaxServer  # noqa: E402
from repro.serving.workload import poisson_arrivals as jax_poisson_arrivals  # noqa: E402
from repro_torch.obs.trace import validate_trace  # noqa: E402
from repro_torch.retrieval import IVFIndex, SyntheticEmbedder  # noqa: E402
from repro_torch.scripts import export_trace  # noqa: E402
from repro_torch.scripts import make_golden_fingerprints as fingerprint_script  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# a small run that shows the fault path: 8 requests over 2 workers, seeded faults
TRACE_ARGS = ["--n-requests", "8", "--ret-workers", "2", "--fault-seed", "3"]


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def indexes():
    jfp = _load_jax_script("make_golden_fingerprints")
    jidx, jemb = jfp.fixture()
    tidx = IVFIndex(centroids=jidx.centroids, flat=jidx.flat, flat_norms=jidx.flat_norms,
                    ids=jidx.ids, offsets=jidx.offsets, radii=jidx.radii)
    return jfp, jidx, jemb, tidx, SyntheticEmbedder(jemb.topic_vecs)


def test_fingerprints_match_the_jax_script(indexes):
    jfp, jidx, jemb, tidx, temb = indexes
    want = {}
    arrivals = jax_poisson_arrivals(8.0, 20, seed=5)
    for mode in jfp.MODES:
        for nw in jfp.WORKERS:  # the loop of the JAX script's main
            be = JaxSimBackend(jidx, jemb, cost_model=jfp.RET_HEAVY, seed=0)
            s = JaxServer(jidx, jemb, mode=mode, backend=be, nprobe=12, topk=5,
                          num_ret_workers=nw)
            for i, t in enumerate(arrivals):
                s.add_request(f"q{i}", jax_workflows.build(jfp.NAMES[i % 5]), arrival_us=float(t))
            assert s.run().finished == 20
            want[f"{mode}-nw{nw}"] = jfp.trace_hash(s)
    assert len(want) == 6
    assert fingerprint_script.fingerprints(tidx, temb) == want


def test_fingerprint_script_writes_only_where_told(tmp_path, monkeypatch, capsys):
    goldens = ROOT / "tests" / "golden_fingerprints.json"
    before = goldens.read_bytes()
    assert fingerprint_script.GOLDENS == goldens.resolve()
    assert fingerprint_script.main(["--out", str(goldens), "--device", "cpu"]) == 2
    assert "refusing" in capsys.readouterr().err
    assert goldens.read_bytes() == before
    monkeypatch.setattr(fingerprint_script, "fingerprints", lambda index, emb: {"hedra-nw1": "x"})
    out = tmp_path / "fp.json"
    assert fingerprint_script.main(["--out", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text()) == {"hedra-nw1": "x"}


def test_trace_export_matches_the_jax_script(indexes, tmp_path, monkeypatch, capsys):
    _, _, _, tidx, temb = indexes
    jexp = _load_jax_script("export_trace")
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["export_trace.py", "--out", str(jpath), *TRACE_ARGS])
    jexp.main()  # builds the same seeded index as the fingerprint script's fixture
    _, m, trace = export_trace.export(tidx, temb,
                                      export_trace.parse_args(["--out", str(tpath), *TRACE_ARGS]))
    assert m.finished == 8 and validate_trace(trace) == []
    got, want = json.loads(tpath.read_text()), json.loads(jpath.read_text())
    assert len(got["traceEvents"]) == len(want["traceEvents"]) > 0
    assert got["traceEvents"] == want["traceEvents"]
    # the generator names its own module: repro.obs.trace in the JAX package
    gen = want["otherData"]["generator"].replace("repro.", "repro_torch.", 1)
    assert dict(got, traceEvents=[]) == dict(want, traceEvents=[],
                                             otherData=dict(want["otherData"], generator=gen))
    assert "fault plan" in capsys.readouterr().out


def test_trace_export_script_runs_on_the_cpu(tmp_path, capsys):
    out, metrics = tmp_path / "t.json", tmp_path / "m.json"
    rc = export_trace.main(["--out", str(out), "--n-requests", "4", "--ret-workers", "2",
                            "--metrics-out", str(metrics), "--attribution", "--device", "cpu"])
    assert rc == 0
    trace = json.loads(out.read_text())
    assert validate_trace(trace) == [] and json.loads(metrics.read_text())
    text = capsys.readouterr().out
    assert "served 4 requests" in text and "bottleneck" in text

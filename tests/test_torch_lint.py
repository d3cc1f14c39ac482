"""repro-lint on the port: the copy in ``repro_torch.analysis.lint`` checks
``src/repro_torch`` under the real rules (its policy's zones name
``repro_torch/...``), the port scans clean, and a violation planted in a
copy of a port module is found exactly once."""
import json
import shutil
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.lint.policy import DEFAULT_POLICY
from repro_torch.core import stages

from _support import run

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


@pytest.fixture(scope="module")
def port_report():
    return run_lint([str(PORT)], root=str(SRC))


def test_port_scans_clean(port_report):
    assert port_report.ok, port_report.render_text()
    assert port_report.findings == []
    assert len(port_report.files) > 50


def test_port_suppressions_are_justified(port_report):
    # as in the JAX package: only RealBackend's measured-execution
    # wall-clock reads are sanctioned
    assert port_report.suppressed
    assert {f.rule for f in port_report.suppressed} == {"determinism/wall-clock"}
    assert all(f.path == "repro_torch/core/backends.py" for f in port_report.suppressed)


def test_policy_kinds_match_live_registry():
    assert set(DEFAULT_POLICY.stage_kinds) == set(stages.STAGE_REGISTRY)


def _planted(tmp_path, rel, extra):
    """A scan root holding one port module, ``rel``, with ``extra`` appended."""
    dst = tmp_path / "repro_torch" / rel
    dst.parent.mkdir(parents=True)
    shutil.copy(PORT / rel, dst)
    with open(dst, "a", encoding="utf-8") as f:
        f.write(extra)
    return run_lint([str(tmp_path / "repro_torch")], root=str(tmp_path))


PLANTED_CLOCK = '''

def _planted_clock():
    import time
    return time.time()
'''

PLANTED_SET_ITER = '''

def _planted_order(ids, heap):
    import heapq
    for rid in set(ids):
        heapq.heappush(heap, rid)
'''


@pytest.mark.parametrize("rel,extra,rule", [
    ("core/wavefront.py", PLANTED_CLOCK, "determinism/wall-clock"),
    ("serving/lifecycle.py", PLANTED_SET_ITER, "determinism/set-iteration"),
], ids=["wall-clock-in-core", "set-iteration-in-serving"])
def test_planted_violation_found_once(tmp_path, rel, extra, rule):
    clean = _planted(tmp_path / "clean", rel, "")
    assert clean.findings == []
    report = _planted(tmp_path / "planted", rel, extra)
    assert [(f.path, f.rule) for f in report.findings] == [(f"repro_torch/{rel}", rule)]


def _cli(*args):
    return run([sys.executable, "-m", "repro_torch.analysis.lint", *args], timeout=120,
               cwd=SRC.parent)[0]


def test_cli_exits_zero_on_the_port():
    proc = _cli(str(PORT), "--root", str(SRC))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_cli_default_target_is_the_port():
    proc = _cli("--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["findings"] == []
    assert data["files"] and all(f.startswith("repro_torch/") for f in data["files"])

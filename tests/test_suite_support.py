"""``_support.run``, the helper the port's tests start child processes
with: side by side under one deadline, each child's group reaped; and the
root ``conftest.py``'s time limit on every phase of a test under ``tests/``."""
import os
import re
import signal
import sys
import textwrap
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

from _support import SRC, run

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"
LIMIT_S = 2.0  # the root conftest's limit in each throw-away project
# pytest over the project in the working directory, with the root conftest
# loaded as a plugin and its limit patched down to argv[2] seconds; with
# argv[3] set, an outer 60 s timer is armed before the session and read after
RUNNER = """\
import importlib.util, signal, sys, time
import pytest

spec = importlib.util.spec_from_file_location("root_conftest", sys.argv[1])
limit = importlib.util.module_from_spec(spec)
spec.loader.exec_module(limit)
limit.LIMIT_S = float(sys.argv[2])
if sys.argv[3]:
    def outer(signum, frame):
        print("outer fired")
    signal.signal(signal.SIGALRM, outer)
    signal.setitimer(signal.ITIMER_REAL, 60)
    armed = time.monotonic()
rc = pytest.main(["-q", "-p", "no:cacheprovider", "--junitxml=report.xml"], plugins=[limit])
if sys.argv[3]:
    print("outer left", signal.getitimer(signal.ITIMER_REAL)[0], 60 - (time.monotonic() - armed),
          signal.getsignal(signal.SIGALRM) is outer)
sys.exit(rc)
"""


def _live_in_group(pgid):
    """Pids of the live (not zombie) processes in process group ``pgid``."""
    live = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, _, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == pgid and state != "Z":
            live.append(int(pid))
    return live


def test_run_kills_a_late_child_and_its_group():
    """A child that sleeps past the deadline, with a grandchild of its own:
    the test fails naming it, and nothing of its group lives on."""
    code = ("import os, subprocess, sys, time\n"
            "sub = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
            "print('group', os.getpgrp(), 'grandchild', sub.pid, flush=True)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"children \[0\] still running after 3 s") as e:
        run([sys.executable, "-c", code], timeout=3)
    assert time.monotonic() - t0 < 10
    pgid = int(re.search(r"group (\d+) grandchild", str(e.value)).group(1))
    for _ in range(50):  # the kernel tears a killed process down soon after
        if not _live_in_group(pgid):
            break
        time.sleep(0.1)
    assert _live_in_group(pgid) == []


def test_run_waits_on_all_children_against_one_deadline():
    """Three children that sleep 2 s each finish under a 5 s deadline: they
    run side by side, each in its own session, and come back in argv order
    with their own output."""
    code = ("import os, sys, time\n"
            "time.sleep(2)\n"
            "print(sys.argv[1], os.getsid(0) == os.getpid())\n")
    t0 = time.monotonic()
    done = run(*([sys.executable, "-c", code, str(i)] for i in range(3)), timeout=5)
    assert time.monotonic() - t0 < 5
    assert [(p.returncode, p.stdout) for p in done] == [(0, f"{i} True\n") for i in range(3)]


def test_run_sets_threads_and_path_and_returns_a_failure():
    """Every child gets ``OMP_NUM_THREADS=1`` and ``src`` first on
    ``PYTHONPATH`` over the env it is given; a child that fails comes back
    with its exit code and stderr, and the test is left to judge it."""
    code = ("import os, sys\n"
            "print(os.environ['OMP_NUM_THREADS'], os.environ['PYTHONPATH'], os.environ['KEEP'])\n"
            "sys.exit('no good')\n")
    [p] = run([sys.executable, "-c", code],
              env={"PATH": os.environ["PATH"], "PYTHONPATH": "elsewhere", "KEEP": "kept"})
    assert (p.returncode, p.stderr) == (1, "no good\n")
    assert p.stdout == f"1 {SRC}{os.pathsep}elsewhere kept\n"


def _project(tmp_path, files, outer=False):
    """Write ``files`` (path -> source) into a pytest project at
    ``tmp_path`` and run it through ``RUNNER``; returns the process and
    ``{test: (outcome, seconds, message)}`` from its junit report."""
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    for name, source in files.items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
    [p] = run([sys.executable, "-c", RUNNER, str(ROOT_CONFTEST), str(LIMIT_S), "1" if outer else ""],
              timeout=60, cwd=tmp_path)
    cases = {}
    for case in ET.parse(tmp_path / "report.xml").iter("testcase"):
        bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
        cases[case.get("name")] = (bad[0].tag if bad else "passed", float(case.get("time")),
                                   bad[0].get("message") if bad else None)
    return p, cases


def test_a_stalled_call_fails_at_the_limit_and_the_next_test_runs(tmp_path):
    """A call phase that sleeps past the limit fails with ``PhaseTimeLimit``
    naming it, its stack on stderr; the next test in the file passes."""
    p, cases = _project(tmp_path, {"tests/test_stall.py": """
        import time

        def test_sleeps():
            time.sleep(60)

        def test_next():
            pass
        """})
    outcome, seconds, message = cases["test_sleeps"]
    assert (outcome, cases["test_next"][0]) == ("failure", "passed"), p.stdout
    assert "PhaseTimeLimit: call of tests/test_stall.py::test_sleeps ran past 2 s" in message
    assert LIMIT_S <= seconds < 5 * LIMIT_S
    assert "most recent call first" in p.stdout and "in test_sleeps" in p.stdout


def test_hypothesis_does_not_shrink_through_the_limit(tmp_path):
    """A ``@given`` test that stalls from its 2nd example on fails once, at
    the limit: hypothesis neither catches the limit nor replays the stall."""
    p, cases = _project(tmp_path, {"tests/test_given.py": """
        import time
        from hypothesis import given, settings, strategies as st

        calls = []

        @settings(database=None, deadline=None)
        @given(st.integers())
        def test_stalls(x):
            calls.append(x)
            if len(calls) >= 2:
                with open("stalls.txt", "a") as f:
                    f.write(f"{x}\\n")
                time.sleep(60)
        """})
    outcome, seconds, message = cases["test_stalls"]
    assert outcome == "failure" and "PhaseTimeLimit" in message, p.stdout
    assert seconds < 5 * LIMIT_S
    assert len((tmp_path / "stalls.txt").read_text().splitlines()) == 1


def test_an_outer_timer_and_handler_come_back_after_each_phase(tmp_path):
    """Under an outer 60 s timer armed before the session, each phase runs
    under the limit's own timer and handler; after the session the outer
    handler is back with what its timer had left, and it has not fired."""
    p, cases = _project(tmp_path, {"tests/test_nest.py": """
        import signal, time
        import pytest

        @pytest.fixture
        def slow():
            time.sleep(0.5)
            yield
            time.sleep(0.5)

        def test_inner(slow):
            time.sleep(0.5)
            assert signal.getsignal(signal.SIGALRM).__name__ != "outer"
            assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 2
        """}, outer=True)
    assert cases["test_inner"][0] == "passed", p.stdout
    left, expected, back = re.search(r"outer left (\S+) (\S+) (\S+)", p.stdout).groups()
    assert back == "True" and "outer fired" not in p.stdout
    assert abs(float(left) - float(expected)) < 0.25


def test_a_test_outside_tests_is_not_bounded(tmp_path):
    """The limit holds under ``<rootdir>/tests/`` only: the same sleep past
    it fails there and passes beside it."""
    p, cases = _project(tmp_path, {f"{where}/test_{where}.py": f"""
        import time

        def test_{where}():
            time.sleep(2.5)
        """ for where in ("tests", "other")})
    assert (cases["test_tests"][0], cases["test_other"][0]) == ("failure", "passed"), p.stdout


def test_this_suite_runs_under_the_limit():
    """The root conftest is loaded for this suite and bounds this very
    phase: a timer of at most 300 s is armed."""
    assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 300

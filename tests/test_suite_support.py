"""``_support.run``, the helper the port's tests start child processes
with: side by side under one deadline, each child's group reaped."""
import os
import re
import sys
import time

import pytest

from _support import SRC, run


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

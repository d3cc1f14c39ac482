"""Child processes for the port's tests: started side by side, waited on
against one deadline, and reaped with everything they started."""
import contextlib
import os
import signal
import subprocess
import tempfile
import time
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
# a hung child fails its test with every child's log tail after this long,
# instead of holding its xdist worker until the suite's own limit
DEADLINE_S = 240.0


def run(*argvs, timeout=DEADLINE_S, env=None, cwd=None):
    """Run every argv at once, each in a session of its own with
    ``OMP_NUM_THREADS=1`` and ``src`` first on ``PYTHONPATH`` (over ``env``,
    default ``os.environ``), and wait for all of them against one deadline.
    Every child's process group is killed on the way out, done or not.
    Returns a text ``CompletedProcess`` per argv; fails the test, naming the
    late children, if the deadline passes first."""
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (SRC, env.get("PYTHONPATH"))))
    with contextlib.ExitStack() as stack:
        # files, not pipes: a child that fills a pipe cannot block while
        # another child is waited on
        logs = [[stack.enter_context(tempfile.TemporaryFile()) for _ in "oe"] for _ in argvs]
        procs = []
        stack.callback(_kill, procs)  # before the files close
        for argv, (out, err) in zip(argvs, logs):
            procs.append(subprocess.Popen(argv, stdout=out, stderr=err, env=env, cwd=cwd,
                                          start_new_session=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(max(0.0, deadline - time.monotonic()))
        done = [subprocess.CompletedProcess(p.args, p.returncode, *map(_read, fs))
                for p, fs in zip(procs, logs)]
        late = [i for i, p in enumerate(procs) if p.returncode is None]
        if late:
            tails = "\n".join(f"--- child {i} ({'late' if i in late else f'rc {c.returncode}'}):\n"
                              f"{(c.stdout + c.stderr)[-2000:]}" for i, c in enumerate(done))
            pytest.fail(f"children {late} still running after {timeout:g} s\n{tails}")
        return done


def _read(f):
    f.seek(0)
    return f.read().decode(errors="replace")


def _kill(procs):
    for p in procs:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()

"""One time limit for every phase (setup, call, teardown) of the tests under
``<rootdir>/tests/``: a phase that runs past ``LIMIT_S`` fails that test with
every thread's stack on stderr, and its worker goes on to the next test."""
# At the root and not in tests/conftest.py: the test files that predate the
# port are kept byte-for-byte.
import faulthandler
import signal
import sys
import threading
import time

import pytest

# above tests/_support.DEADLINE_S (240 s), so that a test's own wait on its
# child processes fails first, with their logs
LIMIT_S = 300.0


class PhaseTimeLimit(BaseException):
    """A test phase ran past ``LIMIT_S``. Not an ``Exception``, so that
    hypothesis does not catch it and shrink through the limit."""


def _bounded(item, phase):
    if (not hasattr(signal, "SIGALRM") or threading.current_thread() is not threading.main_thread()
            or item.config.rootpath / "tests" not in item.path.parents):
        yield
        return

    def expire(signum, frame):
        faulthandler.dump_traceback(sys.__stderr__)
        raise PhaseTimeLimit(f"{phase} of {item.nodeid} ran past {LIMIT_S:g} s")

    armed = time.monotonic()
    previous = signal.signal(signal.SIGALRM, expire)
    outer, interval = signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        if outer:  # an outer timer goes on with what it had left
            signal.setitimer(signal.ITIMER_REAL, max(outer - (time.monotonic() - armed), 1e-6),
                             interval)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _bounded(item, "setup")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _bounded(item, "call")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    yield from _bounded(item, "teardown")

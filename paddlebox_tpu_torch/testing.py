"""Test support of the port's own tests (tests/test_torch_*.py): a time
limit on every test.

Each test file imports ``time_limit``; pytest then runs it around every
test of the file (an autouse fixture).  It arms
``faulthandler.dump_traceback_later(TEST_TIME_LIMIT_S, exit=True)`` and
cancels it when the test ends: a test that hangs prints every thread's
stack and ends its process, so the run reports it as failed under its own
name and goes on (under pytest-xdist the worker restarts), instead of
holding the whole run until an outer timeout.

Imported only by tests: it imports pytest, which the package itself
never needs.
"""

from __future__ import annotations

import faulthandler
import sys

import pytest

# seconds a single port test may take.  The slowest port test takes about
# 11 s alone on a CPU and 23 s beside the rest of the suite under
# pytest-xdist on a loaded host; the limit is more than ten times that
TEST_TIME_LIMIT_S = 300.0


def _stderr_fd(config) -> int:
    """The stderr copy pytest's faulthandler plugin keeps outside output
    capture, else this process's stderr."""
    try:
        from _pytest.faulthandler import fault_handler_stderr_fd_key

        return config.stash[fault_handler_stderr_fd_key]
    except (ImportError, KeyError):
        return sys.__stderr__.fileno()


@pytest.fixture(autouse=True)
def time_limit(request):
    faulthandler.dump_traceback_later(
        TEST_TIME_LIMIT_S, exit=True, file=_stderr_fd(request.config))
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()

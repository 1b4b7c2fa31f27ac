"""Run-wide settings for the test suite: a thread budget per xdist worker and
one time limit per test phase.

pytest loads this file before `tests/conftest.py` and before any test module,
so the budget is in the environment before torch, numpy or jax load.
"""

import contextlib
import faulthandler
import os
import signal

# One thread budget per xdist worker: an equal share of the cores this process
# may use. Unbounded, each worker sizes its OpenMP / BLAS pools to the whole
# host, and an OpenMP region that waits for its slowest thread then runs many
# times slower beside the other workers. torch's and MKL's pools and OpenBLAS
# read OMP_NUM_THREADS when they start, and test subprocesses inherit it. A run
# without xdist is unchanged.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _XDIST_WORKERS:
    os.environ["OMP_NUM_THREADS"] = str(max(1, len(os.sched_getaffinity(0)) // _XDIST_WORKERS))

import pytest  # noqa: E402

# One time limit for each phase of a test (setup, call, teardown). Past it the
# phase fails with a stack dump of every thread, and the worker goes on with
# the next test instead of holding the run until the suite's own clock cuts it.
# SIGALRM reaches only Python code, so a hang inside native code (a compile, a
# collective, an OpenMP barrier) is not bounded: 60 s past the limit
# faulthandler dumps its stacks to the run's own stderr, and it runs on. It is
# not ended there because under `--dist loadfile` xdist gives a crashed test's
# file, the crashed test included, to the worker that replaces it.
TEST_TIME_LIMIT_S = 300

_stderr_fd = None


def pytest_configure(config):
    # The real stderr, kept apart from the per-test capture, for the dump of a
    # native hang.
    global _stderr_fd
    _stderr_fd = os.dup(2)


def pytest_unconfigure(config):
    if _stderr_fd is not None:
        os.close(_stderr_fd)


def _over_time_limit(signum, frame):
    faulthandler.dump_traceback(all_threads=True)
    pytest.fail(f"the test ran past its {TEST_TIME_LIMIT_S} s limit", pytrace=False)


@contextlib.contextmanager
def _time_limit():
    previous = signal.signal(signal.SIGALRM, _over_time_limit)
    signal.alarm(TEST_TIME_LIMIT_S)
    faulthandler.dump_traceback_later(TEST_TIME_LIMIT_S + 60, file=_stderr_fd)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _time_limit():
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _time_limit():
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _time_limit():
        yield

"""The test suite's pytest plugin, loaded for every run by the repository's
root ``conftest.py``.

- torch runs on one thread: the suite runs one worker process per core, and
  torch's own intra-op threads would only contend with them.
- Tests of the JAX package that take more than 60 s on one worker, or more
  than 8 GB of RSS, at the Tier-1 command carry the ``slow`` mark (``SLOW``):
  the default run (``-m 'not slow'``) leaves them out, ``pytest -m slow`` runs
  them.  A test of the port is never ``slow``.
- Every test runs under a time limit (``_limit_s``).
- xdist's ``--dist load`` hands out runs of at most four tests.
- After each test the heap it freed goes back to the system.
"""

import contextlib
import ctypes
import faulthandler
import os
import signal
import sys
import time

import pytest

try:
    import torch
except ImportError:  # the JAX package's tests do not need torch
    pass
else:
    torch.set_num_threads(1)

# Every test (setup, call and teardown together) runs under TEST_LIMIT_S, a
# ``slow`` one under SLOW_LIMIT_S, and one with a ``time_limit`` mark under its
# seconds.  Past the limit a SIGALRM fails the test under its own name once
# control returns to Python.  A test stuck inside C code (an XLA compile, a
# BLAS call) cannot see that signal, so a faulthandler backstop a fifth of the
# limit (plus 5 s) later dumps every thread's stack and ends the process;
# xdist reports that as a crashed worker and fails the test it was running.
TEST_LIMIT_S = 300.0
# twice the longest `slow` test measured, test_sf_mcol_mgga_gradient_vs_fd
# (1704 s in its own process)
SLOW_LIMIT_S = 3600.0
# A test that runs a child process gives the child less than its own limit,
# so that the child is stopped first and the failure names what it ran.  A
# child that ``tests/conftest.py``'s rerun_in_virtual_mesh starts runs its
# tests under this limit.
CHILD_LIMIT_S = TEST_LIMIT_S - 60.0

# The JAX package's `slow` tests, by node id, with the reading that put them
# there: seconds, or peak RSS, on one worker of the Tier-1 command on this
# repository at 67cc61e (warm XLA compile cache; 6 workers, 8-core host),
# or in a process of their own where that run never reached them.
SLOW = {
    "tests/test_jaxints.py::test_jaxints_matches_host_engine":
        "584 s, nearly all of it the ERI blocks' XLA compiles; its S/T/V "
        "half runs by default in test_jaxints_one_electron.py",
    "tests/test_grad_tdhf.py::test_rtdhf_ks_gradient_vs_fd":
        "515 s and 27.5 GB in its own process",
    "tests/test_grad_analytic.py::test_mgga_ground_and_tda_gradient_vs_fd":
        "260 s",
    "tests/test_grad_x2c.py::test_x2c_excited_gradient_vs_fd": "176 s",
    "tests/test_grad_tdhf.py::test_xtdhf_ks_gradient_vs_fd": "153 s",
    "tests/test_jaxints.py::test_jaxints_gradient_vs_fd": "125 s",
    "tests/test_production.py::test_ttm_stda_cross_check": "103 s",
    "tests/test_grad_analytic.py::test_sf_mcol_states_and_gradient": "92 s",
    "tests/test_scf_x2c_vext.py::test_anodz_molecular_quality": "66 s",
    "tests/test_scf_x2c_vext.py::test_v_ext_gradient_vs_fd": "61 s",
    "tests/test_mgga.py::test_tpssh_sf_mcol_dense_vs_sigma":
        "10.0 GB peak in its own process",
    # these four also skip unless XTDDFT_RUN_SLOW is set
    "tests/test_production.py::test_ttm_df_matches_incore_golden":
        "1327 s and 11.4 GB in its own process",
    "tests/test_production.py::test_dzp_cached_operator_matches_golden":
        "DF sigma at 598 AO or more; not measured (its cache is not in "
        "the repository)",
    "tests/test_grad_analytic.py::test_ch2o_ccpvdz_xcis_gradient_vs_stored_fd":
        "15-95 min by its docstring; not measured (LLVM runs out of memory "
        "maps where vm.max_map_count is 65,530)",
    "tests/test_grad_analytic.py::test_sf_mcol_mgga_gradient_vs_fd":
        "1704 s and 30.3 GB in its own process",
}

# Kept tests whose XLA compiles alone run past TEST_LIMIT_S when the compile
# cache (~/.cache/xtddft_tpu_xla_<host>) is empty: about twice their reading
# on a worker of the Tier-1 command with an empty cache.
TIME_LIMITS = {
    "tests/test_grad_analytic.py::test_rsh_cam_b3lyp_states_and_gradient":
        720.0,  # 340-385 s
    "tests/test_grad_analytic.py::test_dft_xtda_states_match_driver":
        720.0,  # 364 s
    "tests/test_grad_analytic.py::test_dft_tda_states_match_driver":
        480.0,  # 213-230 s
}

_DEADLINE = pytest.StashKey[float]()
_stderr_fd = None

# glibc keeps the heap pages a test freed: the multicollinear kernels' ~18 GB
# of temporaries (tests/test_torch_functionals.py) stayed in their worker for
# the rest of the run, and six such workers can run the host out of memory.
# malloc_trim(0) after each test returns the free pages (18.3 -> 1.0 GB there).
try:
    _malloc_trim = ctypes.CDLL("libc.so.6").malloc_trim
except (OSError, AttributeError):  # not glibc
    def _malloc_trim(pad):
        return 0


def _limit_s(item) -> float:
    mark = item.get_closest_marker("time_limit")
    if mark:
        return float(mark.args[0])
    if item.get_closest_marker("slow"):
        return SLOW_LIMIT_S
    if os.environ.get("XTDDFT_IN_MESH_CHILD"):
        return CHILD_LIMIT_S
    return TEST_LIMIT_S


def pytest_configure(config):
    global _stderr_fd
    # the backstop writes to the process's stderr as it was before pytest's
    # capture took fd 2 over
    _stderr_fd = os.dup(sys.__stderr__.fileno())
    # `--dist load` hands a worker runs of up to a quarter of its share of
    # consecutive tests, and a busy worker keeps its run: the JAX package's
    # gradient files, side by side, once held one of six workers on an 8-core
    # host for ~900 s while the other five stood idle.  Runs of at most four
    # bound that wait; an explicit --maxschedchunk wins.
    if getattr(config.option, "maxschedchunk", 0) is None:
        config.option.maxschedchunk = 4


@pytest.hookimpl(tryfirst=True)  # before `-m` deselects by mark
def pytest_collection_modifyitems(items):
    for item in items:
        test = item.nodeid.split("[")[0]
        if test in SLOW:
            item.add_marker(pytest.mark.slow)
        if test in TIME_LIMITS:
            item.add_marker(pytest.mark.time_limit(TIME_LIMITS[test]))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    limit = _limit_s(item)
    item.stash[_DEADLINE] = time.monotonic() + limit
    faulthandler.dump_traceback_later(limit * 1.2 + 5.0, exit=True,
                                      file=_stderr_fd)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        _malloc_trim(0)


@contextlib.contextmanager
def _alarm(item):
    left = item.stash[_DEADLINE] - time.monotonic()
    if left <= 0:  # a teardown after the test already failed on the clock
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of "
                    f"{_limit_s(item):g} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, left)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _alarm(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _alarm(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _alarm(item):
        return (yield)

"""The test suite's plugin (tests/suite.py).  Its per-test time limit, on a
throwaway test file: a test that sleeps past its ``time_limit`` mark fails
under its own name within seconds, and a test stuck in C code, where the
SIGALRM cannot reach it, is ended by the faulthandler backstop, whose stack
dump names it.  Its tables of ``slow`` tests and of limits name tests that
exist, and none of the port's."""

import ast
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

BODIES = {
    "signal": "time.sleep(600)",
    # one C call that never returns to the interpreter until it is done
    "backstop": "sum(range(10 ** 14))",
}


@pytest.mark.parametrize("path", sorted(BODIES))
def test_limit_stops_a_test_past_it(tmp_path, path):
    (tmp_path / "test_throwaway.py").write_text(
        "import time\n\nimport pytest\n\n\n"
        "@pytest.mark.time_limit(2)\n"
        f"def test_past_its_limit():\n    {BODIES[path]}\n")
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-c", str(ROOT / "pyproject.toml"), "--rootdir", str(tmp_path),
         "-p", "tests.suite", str(tmp_path / "test_throwaway.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    took = time.monotonic() - t0
    out = r.stdout + r.stderr
    assert r.returncode != 0, out
    # the child's own start-up (jax and torch imports) is most of this; the
    # backstop fires 2 * 1.2 + 5 s into the test
    assert took < 60, (took, out)
    if path == "signal":
        assert ("test_throwaway.py::test_past_its_limit ran past its time "
                "limit of 2 s") in out, out
        assert "1 failed" in out, out
    else:
        assert "Timeout" in out and "in test_past_its_limit" in out, out


def test_tables_name_tests_of_the_jax_package():
    from tests.suite import SLOW, TIME_LIMITS

    for nodeid in [*SLOW, *TIME_LIMITS]:
        path, name = nodeid.split("::")
        assert not pathlib.Path(path).name.startswith("test_torch_"), nodeid
        tree = ast.parse((ROOT / path).read_text())
        assert name in {f.name for f in tree.body
                        if isinstance(f, ast.FunctionDef)}, nodeid

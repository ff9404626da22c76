"""The benchmark's own tests: the harness's modules (``xbench``, the
reference) and the program import from the benchmark's folder and the
repository's root.  Tests that need a card carry the ``cuda`` marker and
skip without one, deciding inside the test."""

import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""No process of the benchmark holds JAX or the JAX package, and the
reference holds nothing of the program.  Each check runs in a fresh
interpreter and reads its ``sys.modules``, comparing top-level names whole
(``xtddft_tpu_torch`` is not ``xtddft_tpu``)."""

import json
import subprocess
import sys

from xbench import cell as xcell

PRELUDE = f"""
import json, sys
sys.path[:0] = [{str(xcell.HERE)!r}, {str(xcell.REPO)!r}]
"""
REPORT = "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def _top_level(body: str) -> set:
    r = subprocess.run([sys.executable, "-c", PRELUDE + body + "\n" + REPORT],
                       capture_output=True, text=True, timeout=600, cwd=str(xcell.REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.splitlines()[-1]))


def test_a_run_holds_no_jax():
    mods = _top_level("""
import io, time, torch
torch.set_num_threads(1)
sys.path.insert(0, str(__import__('pathlib').Path(sys.path[0]) / 'tests'))
import run
from bench_tiny import tiny_cell
from xbench import cell
cell.run(tiny_cell('flip'), 3, 0.05, True, 'cpu', time.perf_counter(),
         out=io.StringIO(), err=io.StringIO())
""")
    assert "xtddft_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "xtddft_tpu"}


def test_the_reference_holds_nothing_of_the_program():
    mods = _top_level("import reference.sigma, reference.davidson, reference.xc")
    assert not mods & {"jax", "jaxlib", "flax", "xtddft_tpu", "xtddft_tpu_torch"}

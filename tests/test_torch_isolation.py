"""The PyTorch port stands alone: it never loads JAX or the JAX package.

Importing any ``xtddft_tpu`` module starts JAX, and the machine with the GPU
has no JAX at all.  The check runs in a subprocess because this test process
already imports JAX (tests/conftest.py).
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "xtddft_tpu_torch"

SLICE_MODULES = [
    "xtddft_tpu_torch",
    "xtddft_tpu_torch.config",
    "xtddft_tpu_torch.units",
    "xtddft_tpu_torch.chem",
    "xtddft_tpu_torch.ints",
    "xtddft_tpu_torch.ints.native",
    "xtddft_tpu_torch.grids",
    "xtddft_tpu_torch.xc.functionals",
    "xtddft_tpu_torch.xc.interface",
    "xtddft_tpu_torch.scf.env",
    "xtddft_tpu_torch.scf.checkpoint",
    "xtddft_tpu_torch.response.reference_state",
    "xtddft_tpu_torch.response.sigma",
    "xtddft_tpu_torch.response.sigma_df",
    "xtddft_tpu_torch.solver.davidson",
    "xtddft_tpu_torch.props.oscillator",
    "xtddft_tpu_torch.props.spin",
    "xtddft_tpu_torch.methods.drivers",
    "xtddft_tpu_torch.kernels",
]

_JAXISH = re.compile(
    r"^\s*(import\s+(jax|jaxlib|xtddft_tpu)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|xtddft_tpu)\b(?!_torch))", re.M)


def test_import_leaves_jax_unloaded():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'xtddft_tpu'))\n"
        "print(repr(bad))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    src = path.read_text()
    assert not _JAXISH.search(src), f"{path} imports jax or xtddft_tpu"

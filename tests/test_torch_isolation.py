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
    "xtddft_tpu_torch.xc.mcol",
    "xtddft_tpu_torch.chem.geometries",
    "xtddft_tpu_torch.chem.symmetry",
    "xtddft_tpu_torch.scf",
    "xtddft_tpu_torch.scf.env",
    "xtddft_tpu_torch.scf.diis",
    "xtddft_tpu_torch.scf.driver",
    "xtddft_tpu_torch.scf.checkpoint",
    "xtddft_tpu_torch.scf.project",
    "xtddft_tpu_torch.scf.guess",
    "xtddft_tpu_torch.scf.occupations",
    "xtddft_tpu_torch.response.reference_state",
    "xtddft_tpu_torch.response.sigma",
    "xtddft_tpu_torch.response.sigma_df",
    "xtddft_tpu_torch.response.spaces",
    "xtddft_tpu_torch.response.xsf_terms",
    "xtddft_tpu_torch.response.flops",
    "xtddft_tpu_torch.response.moeri",
    "xtddft_tpu_torch.response.fxc_tensor",
    "xtddft_tpu_torch.response.dense",
    "xtddft_tpu_torch.response.sigma_xsf",
    "xtddft_tpu_torch.solver.davidson",
    "xtddft_tpu_torch.solver.rpa",
    "xtddft_tpu_torch.response.tdhf",
    "xtddft_tpu_torch.stda",
    "xtddft_tpu_torch.stda.hardness",
    "xtddft_tpu_torch.stda.core",
    "xtddft_tpu_torch.stda.driver",
    "xtddft_tpu_torch.stda.diagnostics",
    "xtddft_tpu_torch.kernels.stda_coupling",
    "xtddft_tpu_torch.props.oscillator",
    "xtddft_tpu_torch.props.spin",
    "xtddft_tpu_torch.props.irreps",
    "xtddft_tpu_torch.props.tdm",
    "xtddft_tpu_torch.props.diagnostics",
    "xtddft_tpu_torch.props.export",
    "xtddft_tpu_torch.methods.drivers",
    "xtddft_tpu_torch.kernels",
    "xtddft_tpu_torch.ints.two_electron",
    "xtddft_tpu_torch.ints.soc_ints",
    "xtddft_tpu_torch.scf.stability",
    "xtddft_tpu_torch.soc",
    "xtddft_tpu_torch.soc.x2c",
    "xtddft_tpu_torch.soc.somf",
    "xtddft_tpu_torch.soc.si",
    "xtddft_tpu_torch.soc.pipeline",
    "xtddft_tpu_torch.soc.zeeman",
    "xtddft_tpu_torch.soc.interop",
    "xtddft_tpu_torch.grad",
    "xtddft_tpu_torch.grad.lagrangian",
    "xtddft_tpu_torch.grad.xcgrid",
    "xtddft_tpu_torch.grad.x2c_diff",
    "xtddft_tpu_torch.grad.analytic",
    "xtddft_tpu_torch.grad.fd",
    "xtddft_tpu_torch.ints.diffints",
    "xtddft_tpu_torch.kernels.eri_grad",
]

_JAXISH = re.compile(
    r"^\s*(import\s+(jax|jaxlib|xtddft_tpu)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|xtddft_tpu)\b(?!_torch))", re.M)


def test_import_leaves_jax_unloaded():
    from tests.suite import CHILD_LIMIT_S

    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'xtddft_tpu'))\n"
        "print(repr(bad))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=CHILD_LIMIT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    src = path.read_text()
    assert not _JAXISH.search(src), f"{path} imports jax or xtddft_tpu"


_BENCH = re.compile(r"^\s*(import\s+bench\b|from\s+bench\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_bench_import(path):
    """The repository's ``bench.py`` belongs to the JAX system: the port
    keeps its own copy of what it needs (``response/flops.py``)."""
    assert not _BENCH.search(path.read_text()), f"{path} imports bench"

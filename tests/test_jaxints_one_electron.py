"""The one-electron half of ``test_jaxints.py::test_jaxints_matches_host_engine``:
S, T and V of the differentiable integral layer (ints/jaxints.py) against the
host engine, with the same gates.  The whole test, ERIs included, is ``slow``
(tests/suite.py): its cost is the ERI blocks' XLA compiles, which this half
leaves out (``do_eri=False``)."""

import numpy as np

from xtddft_tpu.chem import Molecule
from xtddft_tpu.ints import build_layout
from xtddft_tpu.ints.jaxints import make_integral_fn
from xtddft_tpu.ints.one_electron import kinetic, nuclear_attraction, overlap


def test_jaxints_one_electron_matches_host_engine():
    water = Molecule.from_atoms(
        [("O", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.8)),
         ("H", (1.7, 0.0, -0.4))],
        basis="6-31g", unit="bohr",
    )
    lay = build_layout(water)
    ints = make_integral_fn(lay, do_eri=False)(np.asarray(water.coords))
    assert np.abs(np.asarray(ints["S"]) - np.asarray(overlap(lay))).max() < 1e-13
    # relative gate: steep-primitive kinetic elements reach ~30, and the
    # block-jit executables sum primitive pairs in a different order
    # than the host engine (f64 rounding-order noise, ~1e-13 relative)
    T_host = np.asarray(kinetic(lay))
    assert (np.abs(np.asarray(ints["T"]) - T_host).max()
            < 1e-12 * max(1.0, np.abs(T_host).max()))
    assert (
        np.abs(np.asarray(ints["V"]) - np.asarray(nuclear_attraction(lay))).max()
        < 1e-12
    )

"""Two-electron repulsion integrals for density fitting (3-center, 2-center).

Both run on the native McMurchie-Davidson engine (`xtddft_native/md_eri.cpp`,
built from source by `ints/native.py`).  The optional ``omega`` gives
erf(omega*r12)/r12 attenuated integrals (range-separated hybrids).  The
in-core 4-center tensor and the pure-Python engine of the JAX package are
not part of this package: the DF response path never forms nao^4 ERIs.
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.ints import native
from xtddft_tpu_torch.ints.shell import BasisLayout


def eri_3c(layout: BasisLayout, aux: BasisLayout, omega=None) -> np.ndarray:
    """(P|mu nu) three-center integrals, shape (naux, nao, nao)."""
    return native.eri_3c_native(layout, aux, omega=omega or 0.0)


def eri_2c(aux: BasisLayout, omega=None) -> np.ndarray:
    """(P|Q) two-center Coulomb metric, shape (naux, naux)."""
    return native.eri_2c_native(aux, omega=omega or 0.0)

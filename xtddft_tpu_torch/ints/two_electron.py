"""Two-electron repulsion integrals: 3- and 2-center for density fitting,
4-center for the in-core route.

All run on the native McMurchie-Davidson engine (`xtddft_native/md_eri.cpp`,
built from source by `ints/native.py`).  The optional ``omega`` gives
erf(omega*r12)/r12 attenuated integrals (range-separated hybrids).  The
4-center tensor serves the SAD guess's atomic SCFs (`scf/guess.py`) and the
in-core Env (`scf/env.py`, df=False: small molecules, as in the JAX
package); the pure-Python engine of the JAX package is not ported.
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


def eri_full(layout: BasisLayout, omega=None) -> np.ndarray:
    """Full (nao, nao, nao, nao) spherical ERI tensor, chemists' notation
    (ij|kl); nao^4 doubles (1.35 GB at 114 AO)."""
    return native.eri_full_native(layout, omega=omega or 0.0)

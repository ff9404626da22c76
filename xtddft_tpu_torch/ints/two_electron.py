"""Two-electron repulsion integrals: 3- and 2-center for density fitting,
4-center for the in-core route.

All run on the native McMurchie-Davidson engine (`xtddft_native/md_eri.cpp`,
built from source by `ints/native.py`).  The optional ``omega`` gives
erf(omega*r12)/r12 attenuated integrals (range-separated hybrids).  The
4-center tensor serves the SAD guess's atomic SCFs (`scf/guess.py`) and the
in-core Env (`scf/env.py`, df=False: small molecules, as in the JAX
package); the pure-Python engine of the JAX package is not ported, apart
from the Hermite index helpers and the spherical transform of a quartet
that the spin-orbit integrals (`ints/soc_ints.py`) share with it.
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.ints import native
from xtddft_tpu_torch.ints.mcmurchie import herm_index_map, herm_indices
from xtddft_tpu_torch.ints.shell import BasisLayout, cart2sph, ncart


def _herm_sign(L: int) -> np.ndarray:
    """(-1)^(t+u+v) of each Hermite index of order <= L."""
    return np.array([(-1.0) ** sum(tuv) for tuv in herm_indices(L)])


def _comb_index(L1: int, L2: int) -> np.ndarray:
    """(nh1, nh2) int array mapping Hermite index pairs to the combined
    index in herm_indices(L1+L2)."""
    h1 = herm_indices(L1)
    h2 = herm_indices(L2)
    full = herm_index_map(L1 + L2)
    out = np.empty((len(h1), len(h2)), dtype=np.int64)
    for i, a in enumerate(h1):
        for j, b in enumerate(h2):
            out[i, j] = full[(a[0] + b[0], a[1] + b[1], a[2] + b[2])]
    return out


def _sph4(block_cart, la, lb, lc, ld):
    """A Cartesian quartet block (flat or (nca, ncb, ncc, ncd)) made
    spherical on all four indices."""
    Ca, Cb, Cc, Cd = cart2sph(la), cart2sph(lb), cart2sph(lc), cart2sph(ld)
    t = block_cart.reshape(ncart(la), ncart(lb), ncart(lc), ncart(ld))
    t = np.einsum("abcd,ai->ibcd", t, Ca)
    t = np.einsum("ibcd,bj->ijcd", t, Cb)
    t = np.einsum("ijcd,ck->ijkd", t, Cc)
    t = np.einsum("ijkd,dl->ijkl", t, Cd)
    return t


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

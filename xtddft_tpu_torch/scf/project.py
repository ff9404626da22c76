"""Cross-basis initial-guess projection (host numpy; a copy of the JAX
package's `scf/project.py` over the port's integrals).

At production sizes the GWH core guess sits outside every SCF basin the
damped/DIIS iteration can reach (TTM/dzp, 598 AO: the map has a locked
period-2 oscillation at E ~ +5000 Ha that survives 0.5-damping).  The
standard production cure — used by pyscf's ``project_init_guess``, which
the reference inherits implicitly through its converged ``mf`` inputs —
is to converge the system in a small basis first and project the MOs:

    C_big = S_big^{-1} S_cross C_small,  then S-orthonormalized.

The cross overlap S_cross comes from the same McMurchie-Davidson engine
as every other integral here: the two layouts' shells are concatenated
into one merged layout and the off-diagonal block of its overlap matrix
is S_cross — no new integral code.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from xtddft_tpu_torch.ints.one_electron import overlap
from xtddft_tpu_torch.ints.shell import BasisLayout

__all__ = ["cross_overlap", "project_mo"]


def cross_overlap(layout_a: BasisLayout, layout_b: BasisLayout) -> np.ndarray:
    """(nao_a, nao_b) overlap between two basis layouts over the same
    molecule/geometry (the layouts' molecules must share coordinates)."""
    ca = np.asarray(layout_a.mol.coords)
    cb = np.asarray(layout_b.mol.coords)
    if ca.shape != cb.shape or not np.allclose(ca, cb):
        raise ValueError("cross_overlap: layouts are on different geometries")
    shells = list(layout_a.shells)
    off = layout_a.nao
    for sh in layout_b.shells:
        shells.append(dataclasses.replace(sh, ao_offset=sh.ao_offset + off))
    merged = BasisLayout(mol=layout_a.mol, shells=tuple(shells),
                         nao=layout_a.nao + layout_b.nao)
    S = overlap(merged)
    return S[: layout_a.nao, layout_a.nao:]


def project_mo(mo_small: np.ndarray, layout_small: BasisLayout,
               layout_big: BasisLayout, s_big: np.ndarray | None = None
               ) -> np.ndarray:
    """Project MO coefficients from a small basis into a big one and
    re-orthonormalize against the big overlap (Cholesky connection, same
    smoothness trick as `grad/lagrangian._orthonormalize`).

    mo_small: (nao_small, nmo) — typically the occupied block (plus a few
    virtuals) of a converged small-basis SCF.  Returns (nao_big, nmo)."""
    S_big = np.asarray(s_big if s_big is not None else overlap(layout_big))
    S_x = cross_overlap(layout_big, layout_small)  # (nbig, nsmall)
    C = np.linalg.solve(S_big, S_x @ np.asarray(mo_small))
    M = C.T @ S_big @ C
    L = np.linalg.cholesky(M)
    return np.linalg.solve(L, C.T).T

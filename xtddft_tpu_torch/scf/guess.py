"""SAD initial guess: superposition of atomic densities (host numpy; a copy
of the JAX package's `scf/guess.py` over the port's integrals).

Spherically-averaged free-atom HF densities in the molecule's own basis,
assembled block-diagonally: the in-house equivalent of pyscf's
``get_init_guess(key='atom')``.  At production sizes (TTM/dzp, 598 AO)
the GWH core guess lands outside every reachable SCF basin; SAD starts
inside it.  ``sad_mo`` gives the ``init=`` orbitals of `SCF.kernel`.

The atomic solver uses FRACTIONAL occupations spread evenly over
near-degenerate eigenlevels (spherical averaging — the standard SAD
construction), so open-shell atoms need no symmetry breaking and the
atomic density is rotationally invariant.  Its J and K come from the
atom's in-core 4-center tensor (`ints/two_electron.py eri_full`), small
at one atom, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["atomic_density", "sad_density", "sad_mo"]

_ATOM_CACHE: dict = {}


def _fractional_occ(e_mo: np.ndarray, nelec: float, degen_tol: float = 1e-6
                    ) -> np.ndarray:
    """Aufbau occupations (2 electrons per orbital) with even spreading
    over groups of degenerate eigenvalues (spherical averaging)."""
    n = e_mo.shape[0]
    occ = np.zeros(n)
    remaining = float(nelec)
    i = 0
    while remaining > 1e-12 and i < n:
        j = i + 1
        while j < n and e_mo[j] - e_mo[j - 1] < degen_tol * max(
                1.0, abs(e_mo[i])):
            j += 1
        g = j - i
        put = min(remaining, 2.0 * g)
        occ[i:j] = put / g
        remaining -= put
        i = j
    return occ


def atomic_density(symbol: str, basis: str, max_cycle: int = 60,
                   damp: float = 0.35) -> np.ndarray:
    """(nao, nao) spin-summed ROHF-flavored density of the neutral free
    atom with spherically-averaged fractional occupations."""
    key = (symbol, basis)
    if key in _ATOM_CACHE:
        return _ATOM_CACHE[key]
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.chem import elements
    from xtddft_tpu_torch.ints.one_electron import (kinetic,
        nuclear_attraction, overlap)
    from xtddft_tpu_torch.ints.shell import build_layout
    from xtddft_tpu_torch.ints.two_electron import eri_full

    mol = Molecule.from_atoms(f"{symbol} 0 0 0", basis=basis,
                              spin=int(elements.charge_of(symbol)) % 2)
    layout = build_layout(mol)
    S = overlap(layout)
    h = kinetic(layout) + nuclear_attraction(layout)
    eri = np.asarray(eri_full(layout))
    nelec = float(elements.charge_of(symbol))

    # symmetric orthogonalization
    w, V = np.linalg.eigh(S)
    X = V @ np.diag(1.0 / np.sqrt(w)) @ V.T

    F = h
    D = None
    converged = False
    for _ in range(max_cycle):
        e_mo, C_ = np.linalg.eigh(X.T @ F @ X)
        C = X @ C_
        occ = _fractional_occ(e_mo, nelec)
        D_new = (C * occ[None, :]) @ C.T
        D = D_new if D is None else (1.0 - damp) * D_new + damp * D
        J = np.einsum("pqrs,rs->pq", eri, D)
        K = np.einsum("prqs,rs->pq", eri, D)
        # spin-averaged exchange on the spin-summed D: for Da=Db=D/2 the
        # per-spin exchange is K(D/2) = 0.5*K(D)
        F_new = h + J - 0.5 * K
        if np.abs(F_new - F).max() < 1e-8:
            F = F_new
            converged = True
            break
        F = F_new
    if not converged:
        import warnings

        warnings.warn(
            f"SAD atomic SCF for {symbol}/{basis} did not reach the 1e-8 "
            f"Fock-change criterion in {max_cycle} cycles; caching the "
            "last iterate (guess quality only)", stacklevel=2)
    _ATOM_CACHE[key] = D
    return D


def sad_density(layout) -> np.ndarray:
    """(nao, nao) block-diagonal spin-summed SAD density for the
    molecule behind ``layout`` (each atom's block = its free-atom
    density in the same basis)."""
    mol = layout.mol
    nao = layout.nao
    D = np.zeros((nao, nao))
    # per-atom AO index ranges from the shells
    for ia, sym in enumerate(mol.symbols):
        idx = np.concatenate([
            np.arange(sh.ao_offset, sh.ao_offset + sh.nao)
            for sh in layout.shells if sh.atom_index == ia
        ])
        Da = atomic_density(sym, mol.basis)
        D[np.ix_(idx, idx)] = Da
    return D


def sad_mo(layout, S: np.ndarray | None = None) -> np.ndarray:
    """S-orthonormal natural orbitals of the SAD density, sorted by
    occupation (descending) — the ``init=`` seed for `SCF.kernel`
    (whose engines consume occupied orbital coefficients, so the
    non-idempotent SAD density is approximated by its top natural
    orbitals; charge redistribution then happens in the first damped
    cycles)."""
    from xtddft_tpu_torch.ints.one_electron import overlap
    from scipy.linalg import eigh as geigh

    D = sad_density(layout)
    S = np.asarray(S if S is not None else overlap(layout))
    n, C = geigh(S @ D @ S, S)
    order = np.argsort(n)[::-1]
    return C[:, order]

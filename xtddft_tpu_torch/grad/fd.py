"""Finite-difference nuclear gradients.

Counterpart of the JAX package's `grad/fd.py`: central differences and the
one-sided second-order stencil (-3E0 + 4E(+h) - E(+2h))/(2h), for any SCF
kind and any excited-state driver; geometries are displaced in bohr, and
each displaced SCF restarts from the reference orbitals on the reference's
device, with its density-fitting choice.
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.chem.molecule import Molecule
from xtddft_tpu_torch.scf.driver import SCF

__all__ = ["fd_gradient", "fd_excited_gradient"]


def _displaced(mol: Molecule, ia: int, x: int, h: float) -> Molecule:
    coords = mol.coords.copy()
    coords[ia, x] += h
    return mol.with_(coords=coords)


def _scf_settings(mf) -> dict:
    return dict(kind=mf.kind, xc=mf.xc.name if mf.xc is not None else None,
                grid_level=mf.env.grid_level, v_ext=getattr(mf, "v_ext", None),
                x2c=bool(getattr(mf.env, "x2c", False)), df=mf.env.df, device=mf.env.device)


def _scf(mol: Molecule, settings: dict, init):
    s = dict(settings)
    mf = SCF(mol, s.pop("kind"), **s).kernel(init=init)
    if not mf.converged:
        raise RuntimeError(f"SCF not converged at displaced geometry {mol.coords}")
    return mf


def fd_gradient(mf, h: float = 1e-3, stencil: str = "central", atoms=None) -> np.ndarray:
    """(natm, 3) ground-state nuclear gradient by finite differences of the
    SCF energy of ``mf``'s kind, functional and grid; ``atoms`` limits the
    displaced atoms (the rest stay zero)."""
    mol = mf.mol
    settings = _scf_settings(mf)

    def energy(ia, x, step):
        return _scf(_displaced(mol, ia, x, step), settings, mf.mo_coeff).e_tot

    g = np.zeros((mol.natm, 3))
    for ia in range(mol.natm) if atoms is None else atoms:
        for x in range(3):
            if stencil == "central":
                g[ia, x] = (energy(ia, x, h) - energy(ia, x, -h)) / (2 * h)
            elif stencil == "forward2":
                g[ia, x] = (-3 * mf.e_tot + 4 * energy(ia, x, h) - energy(ia, x, 2 * h)) / (2 * h)
            else:
                raise ValueError(f"unknown stencil {stencil!r}")
    return g


def fd_excited_gradient(mf, driver_factory, state: int = 0, h: float = 1e-3, atoms=None,
                        components=None) -> np.ndarray:
    """(natm, 3) excited-state gradient d(E_SCF + omega_state)/dR by central
    differences.  driver_factory: callable(mf) -> method driver whose
    .kernel() returns an ExcitationResult (``lambda mf: XTDA(mf,
    nstates=3)``); the root is followed by index.  ``atoms`` limits the
    displaced atoms, ``components`` (a list of (atom, axis)) the displaced
    coordinates; the rest stay zero."""
    mol = mf.mol
    settings = _scf_settings(mf)

    def total_energy(m: Molecule) -> float:
        mf_d = _scf(m, settings, mf.mo_coeff)
        return mf_d.e_tot + float(driver_factory(mf_d).kernel().e[state])

    if components is None:
        components = [(ia, x) for ia in (range(mol.natm) if atoms is None else atoms)
                      for x in range(3)]
    g = np.zeros((mol.natm, 3))
    for ia, x in components:
        g[ia, x] = (total_energy(_displaced(mol, ia, x, h))
                    - total_energy(_displaced(mol, ia, x, -h))) / (2 * h)
    return g

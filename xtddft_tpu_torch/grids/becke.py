"""Becke molecular quadrature grid assembly.

Becke fuzzy-cell partitioning (JCP 88, 2547 (1988)) with Bragg–Slater
atomic size adjustment, over Treutler–Ahlrichs radial × Gauss–Legendre
product angular grids.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from xtddft_tpu_torch.chem.molecule import Molecule
from xtddft_tpu_torch.grids import radial, angular

# Bragg-Slater radii in Angstrom (Slater 1964); index by Z
_BRAGG = np.array([
    0.0,
    0.35, 1.40,
    1.45, 1.05, 0.85, 0.70, 0.65, 0.60, 0.50, 1.50,
    1.80, 1.50, 1.25, 1.10, 1.00, 1.00, 1.00, 1.88,
    2.20, 1.80, 1.60, 1.40, 1.35, 1.40, 1.40, 1.40, 1.35, 1.35, 1.35, 1.35,
    1.30, 1.25, 1.15, 1.15, 1.15, 2.02,
])


@dataclasses.dataclass(frozen=True)
class MolecularGrid:
    coords: np.ndarray  # (ngrid, 3)
    weights: np.ndarray  # (ngrid,)

    @property
    def size(self) -> int:
        return self.weights.shape[0]


def _becke_smooth(mu: np.ndarray, k: int = 3) -> np.ndarray:
    f = mu
    for _ in range(k):
        f = 1.5 * f - 0.5 * f**3
    return f


def _partition_weights(mol: Molecule, points: np.ndarray, iatom: int) -> np.ndarray:
    """Becke weight of atom `iatom` at each point."""
    natm = mol.natm
    if natm == 1:
        return np.ones(points.shape[0])
    coords = mol.coords
    z = mol.charges.astype(int)
    from xtddft_tpu_torch import units

    rad = np.array([_BRAGG[min(zi, len(_BRAGG) - 1)] for zi in z]) * units.ANG2BOHR
    # distances point-to-atom
    d = np.linalg.norm(points[:, None, :] - coords[None, :, :], axis=2)  # (np, natm)
    rij = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=2)
    P = np.ones((points.shape[0], natm))
    for i in range(natm):
        for j in range(natm):
            if i == j:
                continue
            mu = (d[:, i] - d[:, j]) / rij[i, j]
            # atomic size adjustment (Becke appendix)
            chi = rad[i] / rad[j]
            u = (chi - 1.0) / (chi + 1.0)
            a = np.clip(u / (u**2 - 1.0), -0.5, 0.5)
            mu = mu + a * (1.0 - mu**2)
            P[:, i] *= 0.5 * (1.0 - _becke_smooth(mu))
    s = P.sum(axis=1)
    return P[:, iatom] / s


def build_grid(mol: Molecule, level: int = 3) -> MolecularGrid:
    all_coords = []
    all_weights = []
    deg = angular.default_degree(level)
    sph_pts, sph_wts = angular.sphere_grid(deg)
    for ia in range(mol.natm):
        zi = int(mol.charges[ia])
        nrad = radial.default_nrad(zi, level)
        r, wr = radial.treutler_ahlrichs(nrad, zi)
        # outer product: radial x angular
        pts = (
            mol.coords[ia][None, None, :]
            + r[:, None, None] * sph_pts[None, :, :]
        ).reshape(-1, 3)
        wts = (wr[:, None] * r[:, None] ** 2 * sph_wts[None, :]).reshape(-1)
        becke_w = _partition_weights(mol, pts, ia)
        w = wts * becke_w
        keep = np.abs(w) > 1e-14
        all_coords.append(pts[keep])
        all_weights.append(w[keep])
    return MolecularGrid(
        coords=np.concatenate(all_coords, axis=0),
        weights=np.concatenate(all_weights, axis=0),
    )

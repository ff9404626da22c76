"""Angular quadrature on the unit sphere.

Product Gauss–Legendre(cos θ) × trapezoidal(φ) grids: exact for spherical
harmonics up to degree min(2*ntheta-1, nphi-1), fully determined by code
(no large coefficient tables to transcribe).  Slightly more points than
Lebedev at equal degree; accuracy is equivalent, which is what matters for
the fxc quadrature hot path (the grid axis is sharded/blocked anyway).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def sphere_grid(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit-sphere points (n,3) and weights (n,), weights sum to 4*pi."""
    ntheta = degree // 2 + 1
    nphi = degree + 1
    x, wx = np.polynomial.legendre.leggauss(ntheta)  # cos(theta) in (-1,1)
    phi = 2.0 * np.pi * np.arange(nphi) / nphi
    wphi = 2.0 * np.pi / nphi
    st = np.sqrt(1.0 - x**2)
    pts = np.empty((ntheta * nphi, 3))
    wts = np.empty(ntheta * nphi)
    k = 0
    for i in range(ntheta):
        for j in range(nphi):
            pts[k] = (st[i] * np.cos(phi[j]), st[i] * np.sin(phi[j]), x[i])
            wts[k] = wx[i] * wphi
            k += 1
    return pts, wts


def default_degree(level: int = 3) -> int:
    """Angular polynomial degree by grid level (~ Lebedev order at the same
    pyscf level)."""
    return {0: 11, 1: 15, 2: 21, 3: 29, 4: 35, 5: 41, 6: 47, 7: 53, 8: 59, 9: 65}[level]

"""Radial quadrature grids (Treutler–Ahlrichs M4 mapping).

Replaces pyscf.dft.radi.  The reference relies on PySCF's default grids
(`mf.grids`, level 3); here we build Treutler–Ahlrichs radial grids with
Gauss–Chebyshev (2nd kind) abscissas — the same family PySCF defaults to.
"""

from __future__ import annotations

import numpy as np

# Treutler-Ahlrichs xi parameters per nuclear charge (JCP 102, 346 (1995))
_TA_XI = {
    1: 0.8, 2: 0.9,
    3: 1.8, 4: 1.4, 5: 1.3, 6: 1.1, 7: 0.9, 8: 0.9, 9: 0.9, 10: 0.9,
    11: 1.4, 12: 1.3, 13: 1.3, 14: 1.2, 15: 1.1, 16: 1.0, 17: 1.0, 18: 1.0,
    19: 1.5, 20: 1.4, 21: 1.3, 22: 1.2, 23: 1.2, 24: 1.2, 25: 1.2, 26: 1.2,
    27: 1.2, 28: 1.1, 29: 1.1, 30: 1.1, 31: 1.1, 32: 1.0, 33: 0.9, 34: 0.9,
    35: 0.9, 36: 0.9,
}


def treutler_ahlrichs(n: int, charge: int) -> tuple[np.ndarray, np.ndarray]:
    """Radial points and weights (including the r^2 volume factor is NOT
    applied here; weights are for the 1D integral over r in [0, inf))."""
    xi = _TA_XI.get(charge, 1.0)
    i = np.arange(1, n + 1)
    t = i * np.pi / (n + 1)
    x = np.cos(t)  # in (-1, 1)
    ln2 = 1.0 / np.log(2.0)
    a = 0.6
    # r = xi/ln2 * (1+x)^a * ln(2/(1-x))
    r = xi * ln2 * (1.0 + x) ** a * np.log(2.0 / (1.0 - x))
    # dr/dx
    drdx = xi * ln2 * (
        a * (1.0 + x) ** (a - 1.0) * np.log(2.0 / (1.0 - x))
        + (1.0 + x) ** a / (1.0 - x)
    )
    # Gauss-Chebyshev (2nd kind) weights for f(x) on (-1,1):
    # w_i = pi/(n+1) * sin^2(t)/sqrt(1-x^2) = pi/(n+1) * sin(t)
    w = np.pi / (n + 1) * np.sin(t) * drdx
    return r[::-1].copy(), w[::-1].copy()


def default_nrad(charge: int, level: int = 3) -> int:
    """Radial point count heuristic (mirrors pyscf's per-period scaling)."""
    base = {0: 10, 1: 20, 2: 30, 3: 40, 4: 50, 5: 60, 6: 70, 7: 80, 8: 90, 9: 100}[
        level
    ]
    if charge <= 2:
        return base + 10
    if charge <= 10:
        return base + 25
    if charge <= 18:
        return base + 40
    return base + 55

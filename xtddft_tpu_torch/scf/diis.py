"""Pulay DIIS (commutator form) for SCF acceleration.

Host numpy, a copy of the JAX package's `scf/diis.py`: the SCF loop
extrapolates O(nao^2) Fock matrices on the host.
"""

from __future__ import annotations

import numpy as np


class DIIS:
    def __init__(self, max_vec: int = 8):
        self.max_vec = max_vec
        self.errors: list[np.ndarray] = []
        self.focks: list[np.ndarray] = []

    def update(self, fock_flat: np.ndarray, err_flat: np.ndarray) -> np.ndarray:
        self.errors.append(np.asarray(err_flat).ravel())
        self.focks.append(np.asarray(fock_flat).ravel())
        if len(self.errors) > self.max_vec:
            self.errors.pop(0)
            self.focks.pop(0)
        n = len(self.errors)
        if n < 2:
            return self.focks[-1]
        B = np.empty((n + 1, n + 1))
        B[-1, :] = -1.0
        B[:, -1] = -1.0
        B[-1, -1] = 0.0
        for i in range(n):
            for j in range(n):
                B[i, j] = self.errors[i] @ self.errors[j]
        rhs = np.zeros(n + 1)
        rhs[-1] = -1.0
        try:
            c = np.linalg.solve(B, rhs)[:n]
        except np.linalg.LinAlgError:
            c = np.linalg.lstsq(B, rhs, rcond=None)[0][:n]
        return sum(ci * fi for ci, fi in zip(c, self.focks))

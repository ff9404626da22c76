"""The converged mean field that the response consumes.

Only the `MeanField` container of the JAX package's `scf/driver.py`; the SCF
iterations themselves are not ported yet (ROADMAP queue 1, item 8), so a
mean field comes from a checkpoint (`scf/checkpoint.load_mf`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from xtddft_tpu_torch.chem.molecule import Molecule
from xtddft_tpu_torch.scf.env import Env
from xtddft_tpu_torch.xc import registry as xc_registry


@dataclasses.dataclass
class MeanField:
    mol: Molecule
    env: Env
    kind: str  # rhf|uhf|rohf|rks|uks|roks
    xc: xc_registry.XCSpec | None
    mo_coeff: np.ndarray  # (nao, nmo) or (2, nao, nmo)
    mo_energy: np.ndarray
    mo_occ: np.ndarray
    e_tot: float
    converged: bool
    fock_a: np.ndarray  # AO-basis converged alpha Fock (h+veff_a)
    fock_b: np.ndarray
    v_ext: np.ndarray | None = None

    @property
    def is_restricted_open(self) -> bool:
        return self.kind in ("rohf", "roks")

    @property
    def is_unrestricted(self) -> bool:
        return self.kind in ("uhf", "uks")

    def make_rdm1(self):
        if self.is_unrestricted:
            ca = self.mo_coeff[0][:, self.mo_occ[0] > 0]
            cb = self.mo_coeff[1][:, self.mo_occ[1] > 0]
            return np.stack([ca @ ca.T, cb @ cb.T])
        if self.is_restricted_open:
            ca = self.mo_coeff[:, self.mo_occ >= 1]
            cb = self.mo_coeff[:, self.mo_occ >= 2]
            return np.stack([ca @ ca.T, cb @ cb.T])
        c = self.mo_coeff[:, self.mo_occ > 0]
        return 2.0 * (c @ c.T)

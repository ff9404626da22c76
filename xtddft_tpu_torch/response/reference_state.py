"""Response reference state extracted from a converged MeanField.

Counterpart of the JAX package's `response/reference_state.py`:

- UKS-style orbital view (a ROKS reference is expanded to equal alpha/beta
  orbitals), re-ordered core|open|virtual
- MO-basis converged Fock matrices F_alpha, F_beta
- the HF-flavored Fock pair on the SCF density (the ingredient of the
  spin-adapted dA terms), built from the Env's DF J/K on the device
- xc specification

Orbitals and MO Fock matrices stay host numpy in f64; they are small.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from xtddft_tpu_torch.scf.driver import MeanField
from xtddft_tpu_torch.scf.env import Env
from xtddft_tpu_torch.xc.registry import XCSpec


@dataclasses.dataclass
class Reference:
    mf: MeanField
    env: Env
    spec: XCSpec | None
    restricted_open: bool  # ROKS/ROHF (spin-adapted dA available)
    mo_a: np.ndarray  # (nao, nmo), core|open|virtual
    mo_b: np.ndarray
    nc: int
    no: int
    nv: int
    fock_a_mo: np.ndarray
    fock_b_mo: np.ndarray
    # HF-flavored Fock pair on the SCF density (dA ingredients); None for UKS
    fock_a_hf_mo: np.ndarray | None
    fock_b_hf_mo: np.ndarray | None

    @property
    def nocc_a(self) -> int:
        return self.nc + self.no

    @property
    def nocc_b(self) -> int:
        return self.nc

    @property
    def nvir_a(self) -> int:
        return self.nv

    @property
    def nvir_b(self) -> int:
        return self.no + self.nv

    @property
    def nmo(self) -> int:
        return self.mo_a.shape[1]

    @property
    def hyb(self) -> float:
        return self.spec.hyb if self.spec is not None else 1.0

    @property
    def alpha(self) -> float:
        return self.spec.alpha if self.spec is not None else 1.0

    @property
    def omega(self) -> float:
        return self.spec.omega if self.spec is not None else 0.0

    @property
    def si(self) -> float:
        """Reference spin S (the open-shell count / 2)."""
        return 0.5 * self.no

    @property
    def orbo_a(self):
        return self.mo_a[:, : self.nocc_a]

    @property
    def orbv_a(self):
        return self.mo_a[:, self.nocc_a :]

    @property
    def orbo_b(self):
        return self.mo_b[:, : self.nocc_b]

    @property
    def orbv_b(self):
        return self.mo_b[:, self.nocc_b :]


def _cov_order(mo_occ: np.ndarray) -> np.ndarray:
    """Permutation putting orbitals in core|open|virtual order (each block
    kept in its original relative order)."""
    core = np.where(mo_occ >= 2)[0]
    open_ = np.where(mo_occ == 1)[0]
    virt = np.where(mo_occ == 0)[0]
    return np.concatenate([core, open_, virt])


def make_reference(mf: MeanField, fock_hf_mo=None) -> Reference:
    """fock_hf_mo: optional precomputed (fa_hf_mo, fb_hf_mo) pair in the
    c|o|v MO ordering; otherwise the HF-flavored J/K on the converged
    density is built through the Env's DF J/K on its device."""
    env = mf.env
    if mf.is_unrestricted:
        occ_a, occ_b = mf.mo_occ[0], mf.mo_occ[1]
        order_a = np.argsort(-occ_a, kind="stable")
        order_b = np.argsort(-occ_b, kind="stable")
        mo_a = mf.mo_coeff[0][:, order_a]
        mo_b = mf.mo_coeff[1][:, order_b]
        nc = int((occ_b > 0).sum())
        no = int((occ_a > 0).sum()) - nc
        nv = mo_a.shape[1] - nc - no
        restricted_open = False
    else:
        occ = mf.mo_occ
        order = _cov_order(occ)
        mo_a = mo_b = mf.mo_coeff[:, order]
        nc = int((occ >= 2).sum())
        no = int((occ == 1).sum())
        nv = mo_a.shape[1] - nc - no
        restricted_open = mf.is_restricted_open
    fa_hf_mo = fb_hf_mo = None

    fock_a_mo = mo_a.T @ mf.fock_a @ mo_a
    fock_b_mo = mo_b.T @ mf.fock_b @ mo_b

    if restricted_open and fock_hf_mo is not None:
        fa_hf_mo, fb_hf_mo = fock_hf_mo
    elif restricted_open:
        # HF-flavored veff on the converged (DFT) density
        dm = env.tensor(mf.make_rdm1())
        J = env.get_j(dm[0] + dm[1])
        h = env.hcore
        fa_hf = (h + J - env.get_k(dm[0])).cpu().numpy()
        fb_hf = (h + J - env.get_k(dm[1])).cpu().numpy()
        fa_hf_mo = mo_a.T @ fa_hf @ mo_a
        fb_hf_mo = mo_b.T @ fb_hf @ mo_b

    return Reference(
        mf=mf,
        env=env,
        spec=mf.xc,
        restricted_open=restricted_open,
        mo_a=mo_a,
        mo_b=mo_b,
        nc=nc,
        no=no,
        nv=nv,
        fock_a_mo=fock_a_mo,
        fock_b_mo=fock_b_mo,
        fock_a_hf_mo=fa_hf_mo,
        fock_b_hf_mo=fb_hf_mo,
    )

"""SOC state interaction (SOC-SI) among |S->, |GS>, |S0>, |S+> manifolds.

Counterpart of the JAX package's `soc/si.py`, a re-derivation of
`x2c_hamiltonian/driver/si_driver.py` (class SI_driver): the SOC-dressed
Hamiltonian Heff = Omega + hso over the TDA eigenstates of up to three spin
manifolds, with Wigner-Eckart geometric factors (exact 3j symbols, Racah's
formula in rational arithmetic) and the per-pair reduced matrix elements
of the cases (1)-(61) einsum table.  Oscillator strengths between SOC
states come from the spin-tensor TDM library (`props/tdm.py`).  Host numpy
in complex128: the matrices are of the SI space's size.

State vector layouts (orbitals in core|open|virtual order):
- |S->  [CV1 | CO1 | OV1 | O1O2(no^2, zero diagonal) | O1O1(no)]
- |S0>  [CV0 | CO0 | OV0 | CV1]      (CV1 absent when S = 0)
- |S+>  [CV1]
- |GS>  scalar 1
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from functools import lru_cache
from math import factorial, sqrt

import numpy as np

from xtddft_tpu_torch import units
from xtddft_tpu_torch.props import tdm as tdm_lib

SQ2 = sqrt(2.0)
MANIFOLDS = ("S-", "GS", "S0", "S+")


def _twice(x) -> int:
    t = 2 * float(x)
    if abs(t - round(t)) > 1e-9:
        raise ValueError(f"{x} is not an integer or half-integer")
    return int(round(t))


@lru_cache(maxsize=None)
def wigner_3j(j1, j2, j3, m1, m2, m3) -> float:
    """The Wigner 3j symbol (j1 j2 j3; m1 m2 m3) of integer or half-integer
    arguments by Racah's formula, exact until the final square root; zero
    off the triangle, off m1 + m2 + m3 = 0 or with |m| > j."""
    J = [_twice(x) for x in (j1, j2, j3)]
    M = [_twice(x) for x in (m1, m2, m3)]
    if sum(M) != 0 or any(abs(m) > j or (j - m) % 2 for j, m in zip(J, M)):
        return 0.0
    a, b, c = J
    if (a + b + c) % 2 or c > a + b or c < abs(a - b):
        return 0.0

    def f(n2):  # (n2 / 2)!: every argument below is twice an integer
        return factorial(n2 // 2)

    tri = Fraction(f(a + b - c) * f(a - b + c) * f(-a + b + c), f(a + b + c + 2))
    norm = tri * f(a + M[0]) * f(a - M[0]) * f(b + M[1]) * f(b - M[1]) * f(c + M[2]) * f(c - M[2])
    total = Fraction(0)
    for k in range(0, (a + b + c) // 2 + 1):
        args = (2 * k, c - b + 2 * k + M[0], c - a + 2 * k - M[1], a + b - c - 2 * k,
                a - 2 * k - M[0], b - 2 * k + M[1])
        if min(args) < 0:
            continue
        den = 1
        for x in args:
            den *= f(x)
        total += Fraction((-1) ** k, den)
    phase = (a - b - M[2]) // 2
    return (-1) ** (phase % 2) * float(total) * sqrt(norm)


@lru_cache(maxsize=None)
def wigner_w(S, M, Sp, Mp) -> float:
    """Geometric factor w(S,M,S',M') = (-1)^(S-M) 3j(S,1,S';-M,M-M',M')
    normalized by the (M=S, M'=S') element (`si_driver.py:46-66`)."""
    phase_exp = _twice(S) - _twice(M)
    if phase_exp % 2:
        raise ValueError("S-M must be an integer")
    phase = -1 if (phase_exp // 2) % 2 else 1
    denom = wigner_3j(S, 1, Sp, -S, S - Sp, Sp)
    if abs(denom) < 1e-9:
        return 0.0
    return phase * wigner_3j(S, 1, Sp, -M, M - Mp, Mp) / denom


def vso_to_hm(vso_mo: np.ndarray) -> np.ndarray:
    """(nmo, nmo, 3) spherical components h^m (m = -1, 0, +1) from the
    3-vector Vso in the MO basis (`si_driver.py:228-238`)."""
    nmo = vso_mo.shape[-1]
    hm = np.zeros((nmo, nmo, 3), dtype=np.complex128)
    hm[..., 0] = 1j * vso_mo[0] - vso_mo[1]  # h^+1
    hm[..., 1] = 1j * vso_mo[2] * SQ2  # h^0
    hm[..., 2] = -1j * vso_mo[0] - vso_mo[1]  # h^-1
    assert np.allclose(hm[..., 0], hm[..., 2].conjugate())
    assert np.allclose(hm[..., 1], -hm[..., 1].conjugate())
    return hm[..., ::-1]  # store as (h^-1, h^0, h^+1)


@dataclasses.dataclass
class SIResult:
    eso: np.ndarray  # SOC state energies (hartree, relative to GS ref)
    vso: np.ndarray  # eigenvectors over the (manifold, M, state) basis
    hso: np.ndarray
    omega: np.ndarray
    esf: np.ndarray  # spin-free energy content of each SOC state
    labels: list  # (manifold, M, ith) per basis position
    dmso: np.ndarray | None = None  # SOC-state transition dipoles


class SIDriver:
    """``states``: dict with keys 'S-', 'S0', 'S+' mapping to lists of
    (energy_hartree, X) in the layouts above.  ``vso_mo``: (3, nmo, nmo)
    Vso in MO basis (c|o|v order).  ``ngs``: include the reference state."""

    def __init__(self, S: float, nc: int, no: int, nv: int,
                 vso_mo: np.ndarray, states: dict, ngs: bool = True,
                 dip_mo: np.ndarray | None = None,
                 mu_nuc: np.ndarray | None = None):
        self.S = float(S)
        self.n = (nc, no, nv)
        self.nc, self.no, self.nv = nc, no, nv
        self.hm = vso_to_hm(np.asarray(vso_mo))
        self.dip_mo = dip_mo
        self.mu_nuc = mu_nuc if mu_nuc is not None else np.zeros(3)
        self.states = {k: list(states.get(k, [])) for k in ("S-", "S0", "S+")}
        self.states["GS"] = [(0.0, np.ones(1))] if ngs else []
        if self.S < 1 and self.states["S-"]:
            raise ValueError("|S-> manifold requires reference S >= 1")
        self._setup_dims()

    # ------------------------------------------------------------- layout
    def _setup_dims(self):
        nc, no, nv = self.n
        self.cv, self.co, self.ov, self.oo = nc * nv, nc * no, no * nv, no * no
        cv, co, ov, oo = self.cv, self.co, self.ov, self.oo
        # |S-> block slices
        self.slm = [
            slice(0, cv),
            slice(cv, cv + co),
            slice(cv + co, cv + co + ov),
            slice(cv + co + ov, cv + co + ov + oo),
            slice(cv + co + ov + oo, cv + co + ov + oo + no),
        ]
        # |S0> block slices
        self.sls = [
            slice(0, cv),
            slice(cv, cv + co),
            slice(cv + co, cv + co + ov),
            slice(cv + co + ov, cv + co + ov + cv),
        ]
        # MO-space slices
        self.slc = slice(0, nc)
        self.slo = slice(nc, nc + no)
        self.slv = slice(nc + no, None)
        self.dc = np.eye(nc)
        self.do = np.eye(no)
        self.dv = np.eye(nv)
        # basis positions: per manifold, (2S'+1) M-copies of each state
        S = self.S
        self.spin_of = {"S-": S - 1, "GS": S, "S0": S, "S+": S + 1}
        self.labels = []
        self.offset = {}
        pos = 0
        for man in MANIFOLDS:
            self.offset[man] = pos
            Sm = self.spin_of[man]
            nstate = len(self.states[man])
            for k in range(int(round(2 * Sm + 1))):
                M = -Sm + k
                for i in range(nstate):
                    self.labels.append((man, M, i))
                    pos += 1
        self.dim = pos

    def pos_of(self, man: str, M: float, i: int) -> int:
        Sm = self.spin_of[man]
        k = int(round(M + Sm))
        return self.offset[man] + k * len(self.states[man]) + i

    # ----------------------------------------------------------- assembly
    def kernel(self) -> SIResult:
        import scipy.linalg

        cal_osc = self.dip_mo is not None
        hso = np.zeros((self.dim, self.dim), dtype=np.complex128)
        omega = np.zeros((self.dim, self.dim))
        dm = np.zeros((self.dim, self.dim, 3)) if cal_osc else None
        for mL in MANIFOLDS:
            SL = self.spin_of[mL]
            for Li, (eL, XL) in enumerate(self.states[mL]):
                for mR in MANIFOLDS:
                    SR = self.spin_of[mR]
                    for Ri, (eR, XR) in enumerate(self.states[mR]):
                        h = self._hso_reduced(mL, mR, XL, XR)
                        d = (
                            self._dm_reduced(mL, mR, XL, XR)
                            if cal_osc
                            else None
                        )
                        for kL in range(int(round(2 * SL + 1))):
                            ML = -SL + kL
                            for kR in range(int(round(2 * SR + 1))):
                                MR = -SR + kR
                                Lp = self.pos_of(mL, ML, Li)
                                Rp = self.pos_of(mR, MR, Ri)
                                if Lp > Rp:
                                    continue
                                if h is not None and abs(MR - ML) <= 1:
                                    hso[Lp, Rp] = h[
                                        int(round(MR - ML)) + 1
                                    ] * wigner_w(SL, ML, SR, MR)
                                if d is not None and ML == MR:
                                    dm[Lp, Rp, :] = d
                                if Lp == Rp:
                                    omega[Lp, Rp] = eL
                                    if cal_osc:
                                        dm[Lp, Rp, :] += self.mu_nuc
        hso = np.triu(hso) + np.triu(hso, 1).T.conjugate()
        hso -= np.diag(np.diag(hso))
        heff = hso + omega
        eso, vso = scipy.linalg.eigh(heff)
        esf = np.real(np.diag(vso.T.conjugate() @ omega @ vso))
        dmso = None
        if cal_osc:
            for x in range(3):
                dm[..., x] = np.triu(dm[..., x]) + np.triu(dm[..., x], 1).T
            dmso = np.einsum("ij,ikx,kl->jlx", vso.conjugate(), dm, vso)
        self.result = SIResult(
            eso=eso, vso=vso, hso=hso, omega=omega, esf=esf,
            labels=self.labels, dmso=dmso,
        )
        return self.result

    # ------------------------------------------------- reduced hso elements
    def _hso_reduced(self, mL, mR, XL, XR):
        """<Phi_L||hm||Phi_R> (3,) without the geometric w factor.  Only the
        upper-triangle manifold pairs are implemented (hermiticity fills the
        rest); returns None when the pair is not coupled."""
        key = (mL, mR)
        table = {
            ("S-", "S-"): self._i_smsm,
            ("S-", "GS"): self._i_smgs,
            ("S-", "S0"): self._i_sms0,
            ("S-", "S+"): lambda L, R: np.zeros(3, dtype=np.complex128),
            ("GS", "GS"): lambda L, R: np.zeros(3, dtype=np.complex128),
            ("GS", "S0"): self._i_gss0,
            ("GS", "S+"): self._i_gssp,
            ("S0", "S0"): self._i_s0s0,
            ("S0", "S+"): self._i_s0sp,
            ("S+", "S+"): self._i_spsp,
        }
        if key in table:
            return table[key](XL, XR)
        return None  # lower triangle; filled by hermiticity

    # ---- |S-> x |S-> (cases 1-35, `si_driver.py:520-619`)
    def _i_smsm(self, XL, XR):
        S = self.S
        hm = self.hm
        slc, slo, slv = self.slc, self.slo, self.slv
        nc, no, nv = self.n
        dim = self.cv + self.co + self.ov + self.oo + no
        hX = np.zeros((dim, 3), dtype=np.complex128)
        s0, s1, s2, s3, s4 = self.slm
        Xcv = XR[s0].reshape(nc, nv)
        Xco = XR[s1].reshape(nc, no)
        Xov = XR[s2].reshape(no, nv)
        Xoo = XR[s3].reshape(no, no)
        Xo = XR[s4]
        go = (1 - S) / S + 2 * (S - 1) * self.do  # open-shell weight matrix
        # line 0: CV1 row
        f = (1 - S) / (S * SQ2)
        hX[s0] += f * np.einsum("abm,jb->jam", hm[slv, slv], Xcv).reshape(self.cv, 3)
        hX[s0] += f * np.einsum("jim,jb->ibm", hm[slc, slc], Xcv).reshape(self.cv, 3)
        f = sqrt((2 * S + 1) / S) * (1 - S) / (S * 2)
        hX[s0] += f * np.einsum("atm,jt->jam", hm[slv, slo], Xco).reshape(self.cv, 3)
        hX[s0] += f * np.einsum("tim,tb->ibm", hm[slo, slc], Xov).reshape(self.cv, 3)
        # line 1: CO1 row
        f = sqrt((2 * S + 1) / S) * (1 - S) / (S * 2)
        hX[s1] += f * np.einsum("ia,atm->itm", Xcv, -hm[slv, slo]).reshape(self.co, 3)
        f = -(S - 1) / (S * SQ2)
        hX[s1] += f * np.einsum("jim,jt->itm", hm[slc, slc], Xco).reshape(self.co, 3)
        hX[s1] += (
            f * (2 * S + 1) / (2 * S - 1)
            * np.einsum("utm,jt->jum", hm[slo, slo], Xco)
        ).reshape(self.co, 3)
        f = -(S - 1) / sqrt(S * (2 * S - 1))
        hX[s1] += f * np.einsum("wim,wt->itm", hm[slo, slc], Xoo).reshape(self.co, 3)
        f = -1.0 / (2 * sqrt(S * (2 * S - 1)))
        hX[s1] += f * np.einsum("uim,ut,t->ium", hm[slo, slc], go, Xo).reshape(self.co, 3)
        # line 2: OV1 row
        f = sqrt((2 * S + 1) / S) * (1 - S) / (S * 2)
        hX[s2] += f * np.einsum("ia,tim->tam", Xcv, -hm[slo, slc]).reshape(self.ov, 3)
        f = -(S - 1) / (S * SQ2)
        hX[s2] += f * np.einsum("abm,tb->tam", hm[slv, slv], Xov).reshape(self.ov, 3)
        hX[s2] += (
            f * (2 * S + 1) / (2 * S - 1)
            * np.einsum("tum,tb->ubm", hm[slo, slo], Xov)
        ).reshape(self.ov, 3)
        f = (1 - S) / sqrt(S * (2 * S - 1))
        hX[s2] += f * np.einsum("atm,ut->uam", hm[slv, slo], Xoo).reshape(self.ov, 3)
        f = -1.0 / (2 * sqrt(S * (2 * S - 1)))
        hX[s2] += f * np.einsum("aum,ut,t->uam", hm[slv, slo], go, Xo).reshape(self.ov, 3)
        # line 3: O1O2 row
        f = -(S - 1) / sqrt(S * (2 * S - 1))
        hX[s3] += f * np.einsum("iu,wim,ut->wtm", Xco, -hm[slo, slc], self.do).reshape(self.oo, 3)
        f = (1 - S) / sqrt(S * (2 * S - 1))
        hX[s3] += f * np.einsum("ua,atm,uw->wtm", Xov, -hm[slv, slo], self.do).reshape(self.oo, 3)
        f = -1 / SQ2
        hX[s3] += f * np.einsum("wvm,wt->vtm", hm[slo, slo], Xoo).reshape(self.oo, 3)
        hX[s3] += f * np.einsum("utm,vw,wt->vum", hm[slo, slo], self.do, Xoo).reshape(self.oo, 3)
        hX[s3] += f * np.einsum("uvm,ut,t->vum", hm[slo, slo], self.do, Xo).reshape(self.oo, 3)
        hX[s3] += f * np.einsum("uvm,vt,t->vum", hm[slo, slo], self.do - 1 / S, Xo).reshape(self.oo, 3)
        # line 4: O1O1 row
        f = -1.0 / (2 * sqrt(S * (2 * S - 1)))
        hX[s4] += f * np.einsum("iu,uim,ut->tm", Xco, -hm[slo, slc], go)
        hX[s4] += f * np.einsum("ua,aum,ut->tm", Xov, -hm[slv, slo], go)
        f = -1 / SQ2
        hX[s4] += f * np.einsum("vu,uvm,ut->tm", Xoo, -hm[slo, slo], self.do)
        hX[s4] += f * np.einsum("vu,uvm,vt->tm", Xoo, -hm[slo, slo], self.do - 1 / S)
        return XL @ hX

    # ---- |S-> x |GS> (cases 6/15/23/30/36, `si_driver.py:621-644`)
    def _i_smgs(self, XL, XR):
        S = self.S
        hm = self.hm
        slc, slo, slv = self.slc, self.slo, self.slv
        dim = self.cv + self.co + self.ov + self.oo + self.no
        hX = np.zeros((dim, 3), dtype=np.complex128)
        s0, s1, s2, s3, _ = self.slm
        hX[s0] += sqrt((2 * S - 1) / (2 * S + 1)) * np.einsum(
            "aim->iam", hm[slv, slc]
        ).reshape(self.cv, 3)
        hX[s1] += sqrt((2 * S - 1) / (2 * S)) * np.einsum(
            "uim->ium", hm[slo, slc]
        ).reshape(self.co, 3)
        hX[s2] += sqrt((2 * S - 1) / (2 * S)) * np.einsum(
            "aum->uam", hm[slv, slo]
        ).reshape(self.ov, 3)
        hX[s3] += np.einsum("uvm->vum", hm[slo, slo]).reshape(self.oo, 3)
        return XL @ hX

    # ---- |S-> x |S0> (cases 7-40, `si_driver.py:646-723`)
    def _i_sms0(self, XL, XR):
        S = self.S
        hm = self.hm
        slc, slo, slv = self.slc, self.slo, self.slv
        nc, no, nv = self.n
        dim = self.cv + self.co + self.ov + self.oo + no
        hX = np.zeros((dim, 3), dtype=np.complex128)
        m0, m1, m2, m3, m4 = self.slm
        t0, t1, t2, t3 = self.sls
        Xcv0 = XR[t0].reshape(nc, nv)
        Xco0 = XR[t1].reshape(nc, no)
        Xov0 = XR[t2].reshape(no, nv)
        Xcv1 = XR[t3].reshape(nc, nv)
        # line 0
        f = sqrt((2 * S - 1) / (2 * S + 1)) / SQ2
        hX[m0] += f * np.einsum("abm,jb->jam", hm[slv, slv], Xcv0).reshape(self.cv, 3)
        hX[m0] += f * np.einsum("jim,jb->ibm", -hm[slc, slc], Xcv0).reshape(self.cv, 3)
        f = -sqrt((2 * S - 1) / (2 * S + 1)) / (2 * S)
        hX[m0] += f * np.einsum("atm,jt->jam", hm[slv, slo], Xco0).reshape(self.cv, 3)
        f = sqrt((2 * S - 1) / (2 * S + 1)) / (2 * S)
        hX[m0] += f * np.einsum("tim,tb->ibm", hm[slo, slc], Xov0).reshape(self.cv, 3)
        f = -sqrt(((1 + S) * (2 * S - 1)) / (2 * S * (2 * S + 1)))
        hX[m0] += f * np.einsum("abm,jb->jam", hm[slv, slv], Xcv1).reshape(self.cv, 3)
        hX[m0] += f * np.einsum("jim,jb->ibm", hm[slc, slc], Xcv1).reshape(self.cv, 3)
        # line 1
        f = sqrt((2 * S - 1) / S) / 2.0
        hX[m1] += f * np.einsum("ubm,jb->jum", hm[slo, slv], Xcv0).reshape(self.co, 3)
        f = -sqrt((2 * S - 1) / (2 * S))
        hX[m1] += f * np.einsum("jim,jt->itm", hm[slc, slc], Xco0).reshape(self.co, 3)
        hX[m1] += (
            f / (2 * S - 1)
            * np.einsum("utm,jt->jum", hm[slo, slo], Xco0)
        ).reshape(self.co, 3)
        f = -sqrt((1 + S) * (2 * S - 1)) / (2 * S)
        hX[m1] += f * np.einsum("ubm,jb->jum", hm[slo, slv], Xcv1).reshape(self.co, 3)
        # line 2
        f = -sqrt((2 * S - 1) / S) / 2.0
        hX[m2] += f * np.einsum("jum,jb->ubm", hm[slc, slo], Xcv0).reshape(self.ov, 3)
        f = sqrt((2 * S - 1) / (2 * S))
        hX[m2] += f * np.einsum("abm,tb->tam", hm[slv, slv], Xov0).reshape(self.ov, 3)
        hX[m2] += (
            f / (2 * S - 1)
            * np.einsum("tum,tb->ubm", hm[slo, slo], Xov0)
        ).reshape(self.ov, 3)
        f = -sqrt((1 + S) * (2 * S - 1)) / (2 * S)
        hX[m2] += f * np.einsum("jum,jb->ubm", hm[slc, slo], Xcv1).reshape(self.ov, 3)
        # line 3
        hX[m3] += -1.0 * np.einsum("jvm,jt->vtm", hm[slc, slo], Xco0).reshape(self.oo, 3)
        hX[m3] += 1.0 * np.einsum("ubm,vb->vum", hm[slo, slv], Xov0).reshape(self.oo, 3)
        # line 4
        hX[m4] += -1.0 * np.einsum("jtm,ut,jt->um", hm[slc, slo], self.do - 1.0 / (2 * S), Xco0)
        hX[m4] += 1.0 * np.einsum("tbm,ut,tb->um", hm[slo, slv], self.do - 1.0 / (2 * S), Xov0)
        return XL @ hX

    # ---- |GS> x |S0> (cases 42-45, `si_driver.py:734-749`)
    def _i_gss0(self, XL, XR):
        S = self.S
        hm = self.hm
        slc, slo, slv = self.slc, self.slo, self.slv
        nc, no, nv = self.n
        t0, t1, t2, t3 = self.sls
        out = np.zeros(3, dtype=np.complex128)
        out += -1 / SQ2 * np.einsum(
            "jvm,jv->m", hm[slc, slo], XR[t1].reshape(nc, no)
        )
        out += 1 / SQ2 * np.einsum(
            "vbm,vb->m", hm[slo, slv], XR[t2].reshape(no, nv)
        )
        if S != 0:
            out += -sqrt(S / (1 + S)) * np.einsum(
                "jbm,jb->m", hm[slc, slv], XR[t3].reshape(nc, nv)
            )
        return out

    # ---- |GS> x |S+> (case 46, `si_driver.py:751-758`)
    def _i_gssp(self, XL, XR):
        nc, no, nv = self.n
        return -np.einsum(
            "jbm,jb->m", self.hm[self.slc, self.slv], XR.reshape(nc, nv)
        )

    # ---- |S0> x |S0> (cases 47-59, `si_driver.py:760-831`)
    def _i_s0s0(self, XL, XR):
        S = self.S
        hm = self.hm
        slc, slo, slv = self.slc, self.slo, self.slv
        nc, no, nv = self.n
        hX = np.zeros((XL.shape[0], 3), dtype=np.complex128)
        t0, t1, t2, t3 = self.sls
        Xcv0 = XR[t0].reshape(nc, nv)
        Xco0 = XR[t1].reshape(nc, no)
        Xov0 = XR[t2].reshape(no, nv)
        # line 0
        f = -0.5
        hX[t0] += f * np.einsum("avm,jv->jam", hm[slv, slo], Xco0).reshape(self.cv, 3)
        hX[t0] += f * np.einsum("vim,vb->ibm", hm[slo, slc], Xov0).reshape(self.cv, 3)
        if S != 0:
            Xcv1 = XR[t3].reshape(nc, nv)
            f = -sqrt(S / (2 * (1 + S)))
            hX[t0] += f * np.einsum("abm,jb->jam", hm[slv, slv], Xcv1).reshape(self.cv, 3)
            hX[t0] += f * np.einsum("jim,jb->ibm", -hm[slc, slc], Xcv1).reshape(self.cv, 3)
        # line 1
        f = -0.5
        hX[t1] += f * np.einsum("ia,avm->ivm", Xcv0, -hm[slv, slo]).reshape(self.co, 3)
        f = -1 / SQ2
        hX[t1] += f * np.einsum("uvm,jv->jum", hm[slo, slo], Xco0).reshape(self.co, 3)
        hX[t1] += f * np.einsum("jim,jv->ivm", -hm[slc, slc], Xco0).reshape(self.co, 3)
        if S != 0:
            f = (1 - S) / (2 * sqrt(S * (S + 1)))
            hX[t1] += f * np.einsum("ubm,jb->jum", hm[slo, slv], Xcv1).reshape(self.co, 3)
        # line 2
        f = -0.5
        hX[t2] += f * np.einsum("ia,vim->vam", Xcv0, -hm[slo, slc]).reshape(self.ov, 3)
        f = 1 / SQ2
        hX[t2] += f * np.einsum("abm,vb->vam", hm[slv, slv], Xov0).reshape(self.ov, 3)
        hX[t2] += f * np.einsum("vum,vb->ubm", -hm[slo, slo], Xov0).reshape(self.ov, 3)
        if S != 0:
            f = (S - 1) / (2 * sqrt(S * (S + 1)))
            hX[t2] += f * np.einsum("jum,jb->ubm", hm[slc, slo], Xcv1).reshape(self.ov, 3)
        # line 3
        if S != 0:
            f = -sqrt(S / (2 * (1 + S)))
            hX[t3] += f * np.einsum("ia,abm->ibm", Xcv0, -hm[slv, slv]).reshape(self.cv, 3)
            hX[t3] += f * np.einsum("ia,jim->jam", Xcv0, hm[slc, slc]).reshape(self.cv, 3)
            f = (1 - S) / (2 * sqrt(S * (S + 1)))
            hX[t3] += f * np.einsum("iu,ubm->ibm", Xco0, -hm[slo, slv]).reshape(self.cv, 3)
            f = (S - 1) / (2 * sqrt(S * (S + 1)))
            hX[t3] += f * np.einsum("ua,jum->jam", Xov0, -hm[slc, slo]).reshape(self.cv, 3)
            f = 1 / (SQ2 * (1 + S))
            hX[t3] += f * np.einsum("abm,jb->jam", hm[slv, slv], Xcv1).reshape(self.cv, 3)
            hX[t3] += f * np.einsum("jim,jb->ibm", hm[slc, slc], Xcv1).reshape(self.cv, 3)
        return XL @ hX

    # ---- |S0> x |S+> (cases 51-60, `si_driver.py:833-857`)
    def _i_s0sp(self, XL, XR):
        S = self.S
        hm = self.hm
        slc, slo, slv = self.slc, self.slo, self.slv
        nc, no, nv = self.n
        hX = np.zeros((XL.shape[0], 3), dtype=np.complex128)
        t0, t1, t2, t3 = self.sls
        X = XR.reshape(nc, nv)
        f = 1 / SQ2
        hX[t0] += f * np.einsum("jim,jb->ibm", hm[slc, slc], X).reshape(self.cv, 3)
        hX[t0] += f * np.einsum("abm,jb->jam", -hm[slv, slv], X).reshape(self.cv, 3)
        hX[t1] += -1.0 * np.einsum("ubm,jb->jum", hm[slo, slv], X).reshape(self.co, 3)
        hX[t2] += 1.0 * np.einsum("jum,jb->ubm", hm[slc, slo], X).reshape(self.ov, 3)
        if S != 0:
            f = -sqrt(S / (2 * (S + 1)))
            hX[t3] += f * np.einsum("jim,jb->ibm", hm[slc, slc], X).reshape(self.cv, 3)
            hX[t3] += f * np.einsum("abm,jb->jam", hm[slv, slv], X).reshape(self.cv, 3)
        return XL @ hX

    # ---- |S+> x |S+> (case 61, `si_driver.py:859-869`)
    def _i_spsp(self, XL, XR):
        nc, no, nv = self.n
        hm = self.hm
        XLr = XL.reshape(nc, nv)
        XRr = XR.reshape(nc, nv)
        out = np.zeros(3, dtype=np.complex128)
        f = 1 / SQ2
        out += f * np.einsum("ia,abm,ib->m", XLr, hm[self.slv, self.slv], XRr)
        out += f * np.einsum("ia,jim,ja->m", XLr, hm[self.slc, self.slc], XRr)
        return out

    # ------------------------------------------------- reduced dm elements
    def _dm_reduced(self, mL, mR, XL, XR):
        if self.dip_mo is None:
            return None
        n = self.n
        ints = self.dip_mo
        if mL == mR == "S-":
            return tdm_lib.tdm_s_1(self.S, self._fmt_sm(XL), self._fmt_sm(XR), ints, n)
        if mL == mR == "GS":
            return np.zeros(3)
        if mL == "GS" and mR == "S0":
            return tdm_lib.tdm_gss(self.S, np.ones(1), self._fmt_s0(XR), ints, n)
        if mL == mR == "S0":
            return tdm_lib.tdm_s(self.S, self._fmt_s0(XL), self._fmt_s0(XR), ints, n)
        if mL == mR == "S+":
            nc, no, nv = n
            return tdm_lib.tdm_s1(
                self.S, [XL.reshape(nc, nv)], [XR.reshape(nc, nv)], ints, n
            )
        return np.zeros(3)

    def _fmt_sm(self, X):
        nc, no, nv = self.n
        s0, s1, s2, s3, s4 = self.slm
        return [
            X[s0].reshape(nc, nv),
            X[s1].reshape(nc, no),
            X[s2].reshape(no, nv),
            X[s3].reshape(no, no),
            X[s4],
        ]

    def _fmt_s0(self, X):
        nc, no, nv = self.n
        t0, t1, t2, t3 = self.sls
        out = [
            X[t0].reshape(nc, nv),
            X[t1].reshape(nc, no),
            X[t2].reshape(no, nv),
        ]
        if self.S != 0:
            out.append(X[t3].reshape(nc, nv))
        return out

    # --------------------------------------------------------- reporting
    def summary(self, printnum: int = 100) -> str:
        r = self.result
        lines = [
            f"SOC-SI over {len(self.states['S-'])} |S->, "
            f"{len(self.states['GS'])} |GS>, {len(self.states['S0'])} |S0>, "
            f"{len(self.states['S+'])} |S+> states (dim {self.dim})",
            f"{'No':>4} {'state':>16} {'w%':>6} {'Esf(eV)':>12} "
            f"{'Eso(eV)':>12} {'En-E1(cm-1)':>12}",
        ]
        for i in range(min(printnum, self.dim)):
            v2 = np.abs(r.vso[:, i]) ** 2
            p = int(np.argmax(v2))
            man, M, ith = self.labels[p]
            lines.append(
                f"{i:4d} {f'{ith}-th |{man},{M:+.1f}>':>16} "
                f"{100 * v2[p]:6.1f} {r.esf[i] * units.HA2EV:12.6f} "
                f"{r.eso[i] * units.HA2EV:12.6f} "
                f"{(r.eso[i] - r.eso[0]) * units.HA2EV * units.EV2CM_1:12.2f}"
            )
        return "\n".join(lines)

    def osc_strength(self, i: int, j: int):
        """Oscillator strength f(i <- j) between SOC states."""
        r = self.result
        if r.dmso is None:
            raise ValueError("build the driver with dip_mo to get dipoles")
        d = r.dmso[i, j, :]
        de = r.eso[j] - r.eso[i]
        return float(((2.0 / 3.0) * de * (d.conjugate() @ d)).real)

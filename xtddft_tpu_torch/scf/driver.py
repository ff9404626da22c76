"""Self-consistent field: RHF/UHF/ROHF and RKS/UKS/ROKS, in-core or density fitted.

Counterpart of the JAX package's `scf/driver.py` with its f64 host engine.
The iteration stays on the host in f64 numpy (eigh, DIIS, the Roothaan
Fock: O(nao^2) a cycle); each cycle's Fock build runs on the Env's device.
The two density matrices go up, the Coulomb and exchange matrices come
from the Env's J/K (`Env.get_jk`: one launch of K1 `df_exchange` in AO mode
over density fitting, or two matrix products with the in-core ERIs), the density
on the grid from K2 `grid_rho1` in its hermitian mode, the functional and
its derivatives from ``torch.func``, the XC potential matrices from K3
`grid_back` on the AO table, and the two veff matrices come back.  A
meta-GGA adds the kinetic-energy density (K2's tau row) and its potential
(K3's tau term) to the same two launches.
ROHF/ROKS orbitals are canonicalized with the Roothaan effective Fock (the
pyscf.scf.rohf convention, which the spin-adapted dA terms assume).

``x2c=True`` takes the Env's sfX2C core Hamiltonian.  Not ported: the JAX
package's mixed-precision device engine (``engine="device"``,
`scf/jk_device.py`), which raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from xtddft_tpu_torch.chem.molecule import Molecule
from xtddft_tpu_torch.scf.diis import DIIS
from xtddft_tpu_torch.scf.env import Env
from xtddft_tpu_torch.xc import interface as xci
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

    @property
    def is_ks(self) -> bool:
        return self.kind in ("rks", "uks", "roks")

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

    def spin_square(self):
        if self.is_unrestricted:
            S = _host(self.env.S)
            ca = self.mo_coeff[0][:, self.mo_occ[0] > 0]
            cb = self.mo_coeff[1][:, self.mo_occ[1] > 0]
            na, nb = ca.shape[1], cb.shape[1]
            sab = ca.T @ S @ cb
            sz = 0.5 * (na - nb)
            ss = sz * sz + 0.5 * (na + nb) - np.einsum("ij,ij->", sab, sab)
            return ss, 2.0 * np.sqrt(ss + 0.25)
        s = 0.5 * self.mol.spin
        return s * (s + 1.0), 2.0 * s + 1.0


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as host f64 numpy."""
    return t.detach().to("cpu", torch.float64).numpy()


def _sym_orth(S: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh(S)
    keep = w > 1e-10
    return v[:, keep] / np.sqrt(w[keep])[None, :]


def _gwh_guess(h: np.ndarray, S: np.ndarray) -> np.ndarray:
    d = np.diag(h)
    return 0.875 * S * (d[:, None] + d[None, :])


def _eig(F, X):
    f = X.T @ F @ X
    e, c = np.linalg.eigh(f)
    return e, X @ c


class SCF:
    """Unified SCF driver; use the RHF/UHF/ROHF/RKS/UKS/ROKS wrappers.

    ``device`` places a new f64 Env (the card unless given); ``env=``
    reuses one, with its grid and fitted tensors.  ``profile = True``
    (before ``kernel``) synchronizes the device at each stage of a Fock
    build and sums the seconds per stage into ``stage_seconds``:
    ``upload``, ``jk`` (K1 and the Coulomb GEMM, or the in-core products),
    ``rho`` (K2), ``xc``
    (the functional and K3), ``download`` and ``host`` (eigh, DIIS and the
    rest of the loop).  ``cycles`` counts the Fock builds of the
    last ``kernel``."""

    def __init__(
        self,
        mol: Molecule,
        kind: str,
        xc: str | None = None,
        grid_level: int = 3,
        env: Env | None = None,
        df: bool | None = None,
        aux_beta: float = 2.2,
        aux_mode: str = "full",
        v_ext=None,
        x2c: bool = False,
        engine: str = "host",
        device: torch.device | str | None = None,
    ):
        """v_ext: optional static external AO potential (nao, nao) added to
        the core Hamiltonian (the embedding/solvation hook)."""
        if engine == "device":
            raise NotImplementedError(
                "engine='device' (the mixed-precision DeviceVeff of the JAX "
                "package's scf/jk_device.py): not ported yet (ROADMAP queue 1, "
                "item 9; table row 12); engine='host' builds the Fock matrix "
                "in f64 on the card")
        if engine != "host":
            raise ValueError(f"unknown engine {engine!r}")
        self.mol = mol
        self.kind = kind
        self.v_ext = None if v_ext is None else np.asarray(v_ext)
        self.xc = xc_registry.resolve(xc) if xc is not None else None
        if env is None:
            if df is None:
                # auto: above ~120 AOs the nao^4 in-core tensor (>1.7 GB)
                # stops being the right default
                from xtddft_tpu_torch.ints import build_layout

                df = build_layout(mol).nao > 120
            env = Env(mol, grid_level=grid_level, df=df, aux_beta=aux_beta,
                      aux_mode=aux_mode, x2c=x2c, device=device)
        self.env = env
        self.conv_tol = 1e-11
        self.conv_tol_grad = 1e-7
        self.max_cycle = 200
        self.diis_space = 10
        # damped startup (see kernel): damp=0 disables; the gate is high
        # enough that any healthily-converging run never damps
        self.damp = 0.5
        self.diis_start_grad = 50.0
        self.verbose = 0
        self.engine = engine
        self.profile = False
        self.stage_seconds: dict[str, float] = {}
        self.cycles = 0
        self._t_lap = 0.0

    def _lap(self, stage: str) -> None:
        if not self.profile:
            return
        if self.env.device.type == "cuda":
            torch.cuda.synchronize(self.env.device)
        now = time.perf_counter()
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + now - self._t_lap
        self._t_lap = now

    # -- Fock/energy builders ---------------------------------------------
    def _veff_and_exc(self, da, db):
        """(veff_a, veff_b, e2): two-electron + xc potential (host f64
        numpy) and energy, for host density matrices da, db."""
        env = self.env
        dms = env.tensor(np.stack([da, db]))
        self._lap("upload")
        spec = self.xc
        hyb = spec.hyb if spec is not None else 1.0
        alpha = spec.alpha if spec is not None else 1.0
        omega = spec.omega if spec is not None else 0.0
        k = None
        if hyb != 0.0 or (omega != 0.0 and alpha != 0.0):
            J, K = env.get_jk(dms)
            k = hyb * K
            if omega != 0.0 and abs(alpha - hyb) > 1e-12:
                k = k + (alpha - hyb) * env.get_jk(dms, omega=omega, with_j=False)[1]
        else:
            J = env.get_j(dms[0] + dms[1])
        self._lap("jk")
        veff = J.expand(2, -1, -1)
        exc = 0.0
        if spec is not None and spec.components:
            rho = self._rho_pair(dms[0], dms[1])
            self._lap("rho")
            exc, va, vb = xci.vxc_matrices(spec, env.ao, env.grid_weights, rho)
            veff = veff + torch.stack([va, vb])
            self._lap("xc")
        if k is not None:
            veff = veff - k
        e2 = 0.5 * torch.sum((dms[0] + dms[1]) * J.T)
        if k is not None:
            e2 = e2 - 0.5 * torch.sum(dms * k.transpose(1, 2))
        veff = _host(veff)
        e2 = float(e2 + exc)
        self._lap("download")
        return veff[0], veff[1], e2

    def _rho_pair(self, da, db):
        """(ra, rb, ga, gb[, ta, tb]) on the grid: both spins in one K2
        launch, with the tau row for a meta-GGA (JAX `scf/driver.py:208`)."""
        tau = self.xc is not None and self.xc.needs_tau
        r, g, *t = xci.cache_rho(self.env.ao, torch.stack([da, db]), tau=tau)
        return (r[0], r[1], g[0], g[1]) + ((t[0][0], t[0][1]) if tau else ())

    def _roothaan_fock(self, fa, fb, dc, do_, S):
        """pyscf.scf.rohf.get_roothaan_fock, dc/do_ = closed/open densities."""
        fc = 0.5 * (fa + fb)
        nao = S.shape[0]
        pc = dc @ S
        po = do_ @ S
        pv = np.eye(nao) - pc - po
        f = 0.5 * (pc.T @ fc @ pc)
        f += 0.5 * (po.T @ fc @ po)
        f += 0.5 * (pv.T @ fc @ pv)
        f += po.T @ fb @ pc
        f += po.T @ fa @ pv
        f += pv.T @ fc @ pc
        return f + f.T

    # -- occupation selection ---------------------------------------------
    @staticmethod
    def _select_by_overlap(c_new, S, c_ref, nocc):
        """Maximum-overlap (MOM) occupied-orbital selection."""
        proj = c_new.T @ S @ c_ref  # (nmo, nocc_ref)
        score = np.einsum("ij,ij->i", proj, proj)
        idx = np.sort(np.argsort(-score)[:nocc])
        return idx

    # -- main loop ---------------------------------------------------------
    def kernel(self, occ=None, init=None) -> MeanField:
        """Run the SCF.

        occ:  optional (alpha_indices, beta_indices) selecting a non-aufbau
              state; held by maximum-overlap selection through the iterations.
        init: optional starting mo_coeff ((nao,nmo) or (2,nao,nmo)), e.g. a
              converged aufbau solution whose orbital indices `occ` refers to.
        """
        mol = self.mol
        env = self.env
        S = _host(env.S)
        h = _host(env.hcore)
        if self.v_ext is not None:
            h = h + self.v_ext
        X = _sym_orth(S)
        na, nb = mol.nalpha, mol.nbeta
        enuc = mol.energy_nuc()
        restricted_closed = self.kind in ("rhf", "rks")
        unrestricted = self.kind in ("uhf", "uks")
        if restricted_closed and na != nb:
            raise ValueError("closed-shell SCF requires spin=0")

        f0 = _gwh_guess(h, S)
        if unrestricted:
            e_mo_a, c_a = _eig(f0, X)
            e_mo_b, c_b = e_mo_a.copy(), c_a.copy()
            if init is not None:
                init = np.asarray(init)
                if init.ndim == 2:
                    init = np.stack([init, init])
                c_a, c_b = init[0].copy(), init[1].copy()
        else:
            e_mo, c = _eig(f0, X)
            if init is not None:
                init = np.asarray(init)
                c = (init[0] if init.ndim == 3 else init).copy()

        # occupation control (MOM): `occ` = (alpha_indices, beta_indices)
        # selects a non-aufbau state
        mom_ref_a = mom_ref_b = None
        if occ is not None:
            occ_a0 = np.asarray(occ[0], dtype=int)
            occ_b0 = np.asarray(occ[1], dtype=int)
            assert len(occ_a0) == na and len(occ_b0) == nb
            if unrestricted:
                mom_ref_a = c_a[:, occ_a0]
                mom_ref_b = c_b[:, occ_b0]
            else:
                mom_ref_a = c[:, occ_a0]
                mom_ref_b = c[:, occ_b0]

        diis = DIIS(self.diis_space)
        e_old = 0.0
        # damped-Fock startup: while the orbital gradient is above
        # `diis_start_grad`, diagonalize F_damped = (1-a) F_new + a
        # F_damped_prev and keep the DIIS history empty; once |g| drops
        # below the gate, DIIS takes over from a sane point
        f_damp_state = None
        diis_live = False

        def _stabilize(f_new, err_norm):
            nonlocal f_damp_state, diis_live, diis
            if err_norm > self.diis_start_grad and self.damp > 0.0:
                if diis_live:
                    diis = DIIS(self.diis_space)  # drop divergent history
                    diis_live = False
                f_damp_state = (f_new if f_damp_state is None else
                                (1.0 - self.damp) * f_new
                                + self.damp * f_damp_state)
                return f_damp_state, True
            diis_live = True
            return f_new, False

        converged = False
        fa = fb = None
        idx_a = np.arange(na)
        idx_b = np.arange(nb)
        self.stage_seconds = {}
        self._t_lap = time.perf_counter()
        cycle = -1
        for cycle in range(self.max_cycle):
            if unrestricted:
                if mom_ref_a is not None:
                    idx_a = self._select_by_overlap(c_a, S, mom_ref_a, na)
                    idx_b = self._select_by_overlap(c_b, S, mom_ref_b, nb)
                    mom_ref_a = c_a[:, idx_a]
                    mom_ref_b = c_b[:, idx_b]
                da = c_a[:, idx_a] @ c_a[:, idx_a].T
                db = c_b[:, idx_b] @ c_b[:, idx_b].T
            else:
                if mom_ref_a is not None:
                    idx_a = self._select_by_overlap(c, S, mom_ref_a, na)
                    # doubly-occupied chosen among the occupied set
                    sub = self._select_by_overlap(c[:, idx_a], S, mom_ref_b, nb)
                    idx_b = idx_a[sub]
                    mom_ref_a = c[:, idx_a]
                    mom_ref_b = c[:, idx_b]
                da = c[:, idx_a] @ c[:, idx_a].T
                db = c[:, idx_b] @ c[:, idx_b].T
            self._lap("host")
            veff_a, veff_b, e2 = self._veff_and_exc(da, db)
            fa = h + veff_a
            fb = h + veff_b
            e_tot = float(np.einsum("pq,qp->", h, da + db)) + e2 + enuc

            if restricted_closed:
                err = X.T @ (fa @ (2 * da) @ S - S @ (2 * da) @ fa) @ X
                f_use, damped = _stabilize(fa, np.linalg.norm(err))
                f_eff = (f_use if damped
                         else diis.update(f_use, err).reshape(fa.shape))
                e_mo, c = _eig(f_eff, X)
            elif unrestricted:
                erra = X.T @ (fa @ da @ S - S @ da @ fa) @ X
                errb = X.T @ (fb @ db @ S - S @ db @ fb) @ X
                err = np.concatenate([erra.ravel(), errb.ravel()])
                fcat = np.concatenate([fa.ravel(), fb.ravel()])
                f_use, damped = _stabilize(fcat, np.linalg.norm(err))
                fboth = f_use if damped else diis.update(f_use, err)
                fa_d = fboth[: fa.size].reshape(fa.shape)
                fb_d = fboth[fa.size:].reshape(fb.shape)
                e_mo_a, c_a = _eig(fa_d, X)
                e_mo_b, c_b = _eig(fb_d, X)
            else:  # restricted open shell
                dc = db  # doubly-occ part
                do_ = da - db
                f_ro = self._roothaan_fock(fa, fb, dc, do_, S)
                dtot = da + db
                err = X.T @ (f_ro @ dtot @ S - S @ dtot @ f_ro) @ X
                f_use, damped = _stabilize(f_ro, np.linalg.norm(err))
                f_eff = (f_use if damped
                         else diis.update(f_use, err).reshape(fa.shape))
                e_mo, c = _eig(f_eff, X)
            gnorm = np.linalg.norm(err)
            de = abs(e_tot - e_old)
            e_old = e_tot
            if self.verbose:
                print(f"cycle {cycle:3d}  E = {e_tot:.12f}  dE = {de:.2e}  |g| = {gnorm:.2e}")
            if de < self.conv_tol and gnorm < self.conv_tol_grad and cycle > 1:
                converged = True
                break
        self._lap("host")
        self.cycles = cycle + 1

        nmo = X.shape[1]
        if unrestricted:
            mo_coeff = np.stack([c_a, c_b])
            mo_energy = np.stack([e_mo_a, e_mo_b])
            mo_occ = np.zeros((2, nmo))
            mo_occ[0, idx_a] = 1.0
            mo_occ[1, idx_b] = 1.0
        else:
            mo_coeff = c
            mo_energy = e_mo
            mo_occ = np.zeros(nmo)
            if restricted_closed:
                mo_occ[idx_a] = 2.0
            else:
                mo_occ[idx_a] = 1.0
                mo_occ[idx_b] = 2.0
        return MeanField(
            mol=mol,
            env=env,
            kind=self.kind,
            xc=self.xc,
            mo_coeff=mo_coeff,
            mo_energy=mo_energy,
            mo_occ=mo_occ,
            e_tot=e_tot,
            converged=converged,
            fock_a=fa,
            fock_b=fb,
            v_ext=self.v_ext,
        )


def RHF(mol, **kw):
    return SCF(mol, "rhf", **kw)


def UHF(mol, **kw):
    return SCF(mol, "uhf", **kw)


def ROHF(mol, **kw):
    return SCF(mol, "rohf", **kw)


def RKS(mol, xc="lda", **kw):
    return SCF(mol, "rks", xc=xc, **kw)


def UKS(mol, xc="lda", **kw):
    return SCF(mol, "uks", xc=xc, **kw)


def ROKS(mol, xc="lda", **kw):
    return SCF(mol, "roks", xc=xc, **kw)

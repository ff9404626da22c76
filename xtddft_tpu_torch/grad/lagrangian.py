"""Analytic excited-state nuclear gradients via a differentiable Lagrangian.

Counterpart of the JAX package's `grad/lagrangian.py`, with torch's
autograd and ``torch.func`` over the differentiable integrals of
`ints/diffints.py` (S, T, V), the ERIs through `kernels/eri_grad.py
eri_of_coords` (native-engine values; their coordinate derivative is K5 on
the card) and the differentiable grid of `grad/xcgrid.py`:

1.  Orbitals are C(kappa, R) = C_orth(R) expm(K): C_orth re-orthonormalizes
    the converged MOs against S(R) (a Cholesky connection, equal to C0 at
    the reference geometry) and K is antisymmetric over the nonredundant
    rotation pairs (`scf/stability.py _rot_pairs`, `_rotate`).  SCF
    convergence means g = dE_scf/dkappa = 0.
2.  The Z-vector equation H z = d(omega)/d(kappa) is solved by conjugate
    gradients with Hessian-vector products from ``torch.func.jvp`` of the
    kappa-gradient (tolerance 1e-9, at most 400 iterations, as JAX's
    ``jax.scipy.sparse.linalg.cg``).
3.  The gradient is one reverse pass over the coordinates of
        Phi(R) = E_scf(R, 0) + omega(R, 0) - z . g(R, 0).

omega is the quadratic form X^T A(C) X of each method (CIS, UCIS, X-CIS with
the spin-adapted dA, spin-flip-up CIS, and the TDHF pencil forms
X^T A X + Y^T A Y + 2 X^T B Y), its eigenvectors either from
``torch.func.hessian`` of the same form or, above the JAX package's
footprint rule, from the port's drivers.  KS references add E_xc(R, D):
vxc by ``torch.func.grad`` over the density matrices, the fxc term as the
second directional derivative of E_xc along the transition density.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from xtddft_tpu_torch.ints.diffints import make_integral_fn
from xtddft_tpu_torch.kernels.eri_grad import eri_of_coords
from xtddft_tpu_torch.scf.stability import _rot_pairs, _rotate

__all__ = ["ExcitedGradients", "scf_gradient"]

METHODS = ("cis", "cis-triplet", "ucis", "xcis", "sfcis-up", "rtdhf", "rtdhf-triplet", "utdhf",
           "xtdhf")


def _nuclear_repulsion(coords, charges):
    n = coords.shape[0]
    eye = torch.eye(n, dtype=coords.dtype, device=coords.device)
    d = coords[:, None, :] - coords[None, :, :]
    r = torch.sqrt(torch.sum(d * d, dim=-1) + eye)
    return 0.5 * torch.sum((1.0 - eye) * charges[:, None] * charges[None, :] / r)


def _jk_energy(eri, da, db, hyb: float = 1.0):
    dt = da + db
    J = torch.einsum("pqrs,sr->pq", eri, dt)
    Ka = torch.einsum("prsq,rs->pq", eri, da)
    Kb = torch.einsum("prsq,rs->pq", eri, db)
    e2 = 0.5 * torch.einsum("pq,qp->", dt, J)
    e2 = e2 - 0.5 * hyb * (torch.einsum("pq,qp->", da, Ka) + torch.einsum("pq,qp->", db, Kb))
    return e2, J, Ka, Kb


def _orthonormalize(C0, S):
    """C_orth(R) = C0 L^{-T}, L = chol(C0^T S(R) C0); C0 at the reference."""
    L = torch.linalg.cholesky(C0.T @ S @ C0)
    return torch.linalg.solve_triangular(L, C0.T, upper=False).T


def _cg(A, b, tol: float = 1e-9, maxiter: int = 400):
    """Conjugate gradients for A x = b (A symmetric positive definite, as a
    function), stopping at |r| <= tol |b|.  Returns (x, iterations)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    stop = tol * tol * rs
    it = 0
    while it < maxiter and rs > stop:
        Ap = A(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, it


class ExcitedGradients:
    """Analytic gradients of the excited states of an SCF reference.

    method: 'cis' (RHF/RKS singlet), 'cis-triplet', 'ucis' (UHF/UKS), 'xcis'
    (spin-adapted X-CIS / X-TDA on ROHF/ROKS), 'sfcis-up' (spin-flip-up on
    ROHF/UHF/ROKS/UKS; ``sf_method`` 0 ALDA0, 1 multicollinear for KS),
    'rtdhf', 'rtdhf-triplet', 'utdhf' and 'xtdhf' (the TDHF/RPA pencils).
    Runs on the mean field's device (the card unless its Env was made with
    device="cpu"); the gradient's ERI derivative is K5 there.  ``stats``
    holds the seconds of the last ``kernel``'s stages and its CG iterations.
    """

    def __init__(self, mf, method: str = "xcis", sf_method: int = 0):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
        self.mf = mf
        self.method = method
        self.sf_method = sf_method
        env = mf.env
        self.env = env
        self.device, self.dtype = env.device, env.dtype
        self.v_ext = env.tensor(mf.v_ext) if getattr(mf, "v_ext", None) is not None else None
        self.spec = mf.xc
        self.hyb, self.omega, self.hyb_lr = 1.0, 0.0, 0.0
        self._exc = self._sf_xc = None
        if (self.spec is not None and self.spec.needs_tau and method == "sfcis-up"
                and sf_method != 1):
            raise NotImplementedError(
                "analytic gradients: the ALDA0 spin-flip kernel is not defined for MGGA "
                "functionals; use sf_method=1 (the multicollinear kernel carries tau)")
        layout = env.layout
        if self.spec is not None:
            from xtddft_tpu_torch.grad import xcgrid

            self.hyb = self.spec.hyb
            if abs(self.spec.omega) > 1e-12:
                self.omega = self.spec.omega
                self.hyb_lr = self.spec.alpha - self.spec.hyb
            self._exc = xcgrid.make_exc_fn(mf.mol, layout, self.spec, level=env.grid_level)
            if method == "sfcis-up":
                make = xcgrid.make_sf_mcol_fn if sf_method == 1 else xcgrid.make_sf_alda0_fn
                self._sf_xc = make(mf.mol, layout, self.spec, level=env.grid_level)
        self.kind = mf.kind
        mol = mf.mol
        self.coords0 = np.asarray(mol.coords, dtype=np.float64)
        self.charges = env.tensor(np.asarray(mol.charges, dtype=np.float64))
        self.na, self.nb = mol.nalpha, mol.nbeta
        self._one = make_integral_fn(layout, do_eri=False)
        self._x2c_fn = None
        if getattr(env, "x2c", False):
            from xtddft_tpu_torch import units
            from xtddft_tpu_torch.grad.x2c_diff import make_x2c_hcore_fn

            self._x2c_fn = make_x2c_hcore_fn(layout, units.C_AU)
        if self.kind in ("uhf", "uks"):
            self.C0 = [env.tensor(mf.mo_coeff[0]), env.tensor(mf.mo_coeff[1])]
        else:
            self.C0 = [env.tensor(mf.mo_coeff)]
        self.nmo = self.C0[0].shape[1]
        self.pairs = _rot_pairs(self.kind, self.nmo, self.na, self.nb)
        self.nk = sum(len(p[0]) for p in self.pairs)
        self._ints0_cache = None
        self.stats: dict = {}

    # -- integrals ------------------------------------------------------------
    def _ints(self, coords):
        """S, T, V (diffints), the ERIs (and the long-range ERIs of an RSH)
        through `eri_of_coords`, and the core Hamiltonian h(R) (T + V or the
        sfX2C one), and a KS reference's grid with its AO values, at
        ``coords`` on the mean field's device."""
        ints = self._one(coords)
        layout = self.env.layout
        ints["eri"] = eri_of_coords(coords, layout)
        if self.hyb_lr != 0.0:
            ints["eri_lr"] = eri_of_coords(coords, layout, self.omega)
        ints["h"] = self._x2c_fn(coords) if self._x2c_fn is not None else ints["T"] + ints["V"]
        if self._exc is not None:
            ints["grid"] = self._exc.grid_ao(coords)
        return ints

    def _coords(self, requires_grad: bool = False):
        return torch.tensor(self.coords0, dtype=self.dtype, device=self.device,
                            requires_grad=requires_grad)

    def _ints0(self):
        """The integrals at the reference geometry, made once: every
        orbital-space derivative (Hessian, Z-vector right-hand side, CG)
        reuses them."""
        if self._ints0_cache is None:
            with torch.no_grad():
                self._ints0_cache = self._ints(self._coords())
        return self._ints0_cache

    def _hcore(self, ints):
        return ints["h"] if self.v_ext is None else ints["h"] + self.v_ext

    # -- orbital parametrization ---------------------------------------------
    def _orbs(self, ints, kvec):
        S = ints["S"]
        if self.kind in ("uhf", "uks"):
            n0 = len(self.pairs[0][0])
            return (_rotate(_orthonormalize(self.C0[0], S), kvec[:n0], self.pairs[0], self.nmo),
                    _rotate(_orthonormalize(self.C0[1], S), kvec[n0:], self.pairs[1], self.nmo))
        C = _rotate(_orthonormalize(self.C0[0], S), kvec, self.pairs[0], self.nmo)
        return C, C

    # -- SCF energy -----------------------------------------------------------
    def _e_elec(self, ints, kvec):
        Ca, Cb = self._orbs(ints, kvec)
        da = Ca[:, :self.na] @ Ca[:, :self.na].T
        db = Cb[:, :self.nb] @ Cb[:, :self.nb].T
        e2, _, _, _ = _jk_energy(ints["eri"], da, db, self.hyb)
        if self.hyb_lr != 0.0:
            _, _, Kla, Klb = _jk_energy(ints["eri_lr"], da, db)
            e2 = e2 - 0.5 * self.hyb_lr * (torch.einsum("pq,qp->", da, Kla)
                                           + torch.einsum("pq,qp->", db, Klb))
        e1 = torch.einsum("pq,qp->", self._hcore(ints), da + db)
        if self._exc is not None:
            e2 = e2 + self._exc.on_grid(ints["grid"], da, db)
        return e1 + e2

    def _e_scf(self, coords, kvec):
        return self._e_elec(self._ints(coords), kvec) + _nuclear_repulsion(coords, self.charges)

    # -- the excitation energy as a quadratic form ---------------------------
    def _x_dims(self):
        na, nb, nmo = self.na, self.nb, self.nmo
        m = self.method
        if m in ("cis", "cis-triplet", "rtdhf", "rtdhf-triplet"):
            return [(nb, nmo - nb)]
        if m in ("ucis", "utdhf", "xcis", "xtdhf"):
            return [(na, nmo - na), (nb, nmo - nb)]
        return [(nb, nmo - na)]  # sfcis-up: occupied beta -> virtual alpha

    @property
    def is_tdhf(self) -> bool:
        return self.method in ("rtdhf", "rtdhf-triplet", "utdhf", "xtdhf")

    @property
    def xdim(self) -> int:
        d = sum(o * v for o, v in self._x_dims())
        return 2 * d if self.is_tdhf else d  # packed [X; Y]

    def _omega_i(self, ints, kvec, x):
        """omega = X^T A X of the method; x is the packed, unit-norm
        eigenvector (TDHF: [X; Y] with X^T X - Y^T Y = 1)."""
        eri = ints["eri"]
        Ca, Cb = self._orbs(ints, kvec)
        h = self._hcore(ints)
        na, nb = self.na, self.nb
        da = Ca[:, :na] @ Ca[:, :na].T
        db = Cb[:, :nb] @ Cb[:, :nb].T
        hyb, hyb_lr = self.hyb, self.hyb_lr
        _, J, Ka, Kb = _jk_energy(eri, da, db, hyb)
        Fa = h + J - hyb * Ka
        Fb = h + J - hyb * Kb
        if hyb_lr != 0.0:
            _, _, Kla, Klb = _jk_energy(ints["eri_lr"], da, db)
            Fa = Fa - hyb_lr * Kla
            Fb = Fb - hyb_lr * Klb
        grid = ints.get("grid")
        exc = None if self._exc is None else self._exc.on_grid

        def kx(tl, tr):
            """Exchange contraction with the RSH-combined kernel."""
            out = hyb * torch.einsum("pr,pqrs,qs->", tl, eri, tr)
            if hyb_lr != 0.0:
                out = out + hyb_lr * torch.einsum("pr,pqrs,qs->", tl, ints["eri_lr"], tr)
            return out

        if exc is not None:
            vxa, vxb = torch.func.grad(exc, argnums=(1, 2))(grid, da, db)
            Fa = Fa + vxa
            Fb = Fb + vxb
        Fa_mo = Ca.T @ Fa @ Ca
        Fb_mo = Cb.T @ Fb @ Cb

        def fxc_dir(Ta, Tb):
            """Second directional derivative of E_xc along (Ta, Tb): the
            quadratic fxc term of the A matrix (forward over forward, so
            that the coordinate gradient stays one reverse pass)."""
            if exc is None:
                return 0.0
            zero = torch.zeros((), dtype=da.dtype, device=da.device)
            one = torch.ones((), dtype=da.dtype, device=da.device)

            def g(lam):
                return exc(grid, da + lam * Ta, db + lam * Tb)

            def dg(lam):
                return torch.func.jvp(g, (lam,), (one,))[1]

            return torch.func.jvp(dg, (zero,), (one,))[1]

        def fxc_bilinear(TaX, TbX, TaY, TbY):
            """Bilinear fxc coupling by the polarization identity."""
            if exc is None:
                return 0.0
            return 0.25 * (fxc_dir(TaX + TaY, TbX + TbY) - fxc_dir(TaX - TaY, TbX - TbY))

        def kxb(t1x, t1y):
            """RPA B exchange sum_{iajb} (ib|ja) x_ia y_jb over AO transition
            densities t = Co z Cv^T (the second one transposed), with the
            RSH-combined kernel (`response/tdhf.py _exchange_ibja`)."""
            out = hyb * torch.einsum("pqrs,ps,rq->", eri, t1x, t1y)
            if hyb_lr != 0.0:
                out = out + hyb_lr * torch.einsum("pqrs,ps,rq->", ints["eri_lr"], t1x, t1y)
            return out

        def sym2(t):
            return 0.5 * (t + t.T)

        dims = self._x_dims()
        rt2 = 2.0 ** 0.5

        if self.method in ("rtdhf", "rtdhf-triplet"):
            # omega[X, Y] = X^T A X + Y^T A Y + 2 X^T B Y at the converged
            # amplitudes (stationary under norm-preserving variations)
            singlet = self.method == "rtdhf"
            no, nv = dims[0]
            zx = x[:no * nv].reshape(no, nv)
            zy = x[no * nv:].reshape(no, nv)
            Co, Cv = Ca[:, :no], Ca[:, no:]

            def a_form(z):
                w = torch.einsum("ia,ab,ib->", z, Fa_mo[no:, no:], z)
                w = w - torch.einsum("ia,ij,ja->", z, Fa_mo[:no, :no], z)
                t1 = Co @ z @ Cv.T
                t1s = sym2(t1) / rt2
                if singlet:
                    w = w + 2.0 * torch.einsum("pq,pqrs,rs->", t1, eri, t1) + fxc_dir(t1s, t1s)
                else:
                    w = w + fxc_dir(t1s, -t1s)
                return w - kx(t1, t1)

            def b_form(z1, z2):
                t1 = Co @ z1 @ Cv.T
                t2 = Co @ z2 @ Cv.T
                t1s, t2s = sym2(t1) / rt2, sym2(t2) / rt2
                if singlet:
                    w = (2.0 * torch.einsum("pq,pqrs,rs->", t1, eri, t2)
                         + fxc_bilinear(t1s, t1s, t2s, t2s))
                else:
                    w = fxc_bilinear(t1s, -t1s, t2s, -t2s)
                return w - kxb(t1, t2)

            return a_form(zx) + a_form(zy) + 2.0 * b_form(zx, zy)

        if self.method == "sfcis-up":
            # A_{ia,jb} = d_ij F^a_ab - d_ab F^b_ij - hyb (ab|ji) [+ the SF
            # xc kernel]: no Coulomb term in the spin-flip channel
            no_, nv_ = dims[0]
            z = x.reshape(no_, nv_)
            Cob, Cva = Cb[:, :no_], Ca[:, na:]
            w = torch.einsum("ia,ab,ib->", z, Fa_mo[na:, na:], z)
            w = w - torch.einsum("ia,ij,ja->", z, Fb_mo[:no_, :no_], z)
            t = Cva @ z.T @ Cob.T
            w = w - hyb * torch.einsum("pqrs,ps,qr->", eri, t, t)
            if hyb_lr != 0.0:
                w = w - hyb_lr * torch.einsum("pqrs,ps,qr->", ints["eri_lr"], t, t)
            if self._sf_xc is not None:
                w = w + self._sf_xc.on_grid(grid, da, db, t)
            return w

        if self.method in ("cis", "cis-triplet"):
            no, nv = dims[0]
            z = x.reshape(no, nv)
            Co, Cv = Ca[:, :no], Ca[:, no:]
            w = torch.einsum("ia,ab,ib->", z, Fa_mo[no:, no:], z)
            w = w - torch.einsum("ia,ij,ja->", z, Fa_mo[:no, :no], z)
            t1 = Co @ z @ Cv.T
            # the per-spin transition density is t1/sqrt(2) in the spatial
            # singlet/triplet convention
            t1s = sym2(t1) / rt2
            if self.method == "cis":
                w = w + 2.0 * torch.einsum("pq,pqrs,rs->", t1, eri, t1) + fxc_dir(t1s, t1s)
            else:
                w = w + fxc_dir(t1s, -t1s)
            return w - kx(t1, t1)

        (noa, nva), (nob, nvb) = dims
        d_u = noa * nva + nob * nvb
        Coa, Cva = Ca[:, :noa], Ca[:, noa:]
        Cob, Cvb = Cb[:, :nob], Cb[:, nob:]

        def split(v):
            return v[:noa * nva].reshape(noa, nva), v[noa * nva:].reshape(nob, nvb)

        def a_form_u(za, zb):
            w = torch.einsum("ia,ab,ib->", za, Fa_mo[noa:, noa:], za)
            w = w - torch.einsum("ia,ij,ja->", za, Fa_mo[:noa, :noa], za)
            w = w + torch.einsum("ia,ab,ib->", zb, Fb_mo[nob:, nob:], zb)
            w = w - torch.einsum("ia,ij,ja->", zb, Fb_mo[:nob, :nob], zb)
            t1a = Coa @ za @ Cva.T
            t1b = Cob @ zb @ Cvb.T
            dt = t1a + t1b
            w = w + torch.einsum("pq,pqrs,rs->", dt, eri, dt)
            w = w - kx(t1a, t1a) - kx(t1b, t1b)
            return w + fxc_dir(sym2(t1a), sym2(t1b))

        def b_form_u(za1, zb1, za2, zb2):
            t1a, t1b = Coa @ za1 @ Cva.T, Cob @ zb1 @ Cvb.T
            t2a, t2b = Coa @ za2 @ Cva.T, Cob @ zb2 @ Cvb.T
            w = torch.einsum("pq,pqrs,rs->", t1a + t1b, eri, t2a + t2b)
            w = w - kxb(t1a, t2a) - kxb(t1b, t2b)
            return w + fxc_bilinear(sym2(t1a), sym2(t1b), sym2(t2a), sym2(t2b))

        if self.method == "ucis":
            return a_form_u(*split(x))
        if self.method == "utdhf":
            zxa, zxb = split(x[:d_u])
            zya, zyb = split(x[d_u:])
            return a_form_u(zxa, zxb) + a_form_u(zya, zyb) + 2.0 * b_form_u(zxa, zxb, zya, zyb)

        # X-CIS spin adaptation: dA from the HF-flavoured alpha/beta Fock
        # difference on the SCF density with the S-dependent factors of
        # `xtddft/XTDA.py:298-307`; for a KS reference dF = Ka - Kb with
        # full exchange, whatever the functional's hyb
        def da_form(za, zb):
            nc, no = nb, na - nb
            si = 0.5 * no
            f1 = 0.5 * (1.0 - ((si + 1) / si) ** 0.5 + 1.0 / (2 * si))
            f2 = 0.5 * (-1.0 + ((si + 1) / si) ** 0.5 + 1.0 / (2 * si))
            fx = 0.5 / (2.0 * si)
            dF = Fb_mo - Fa_mo if exc is None else Ca.T @ (Ka - Kb) @ Ca
            dFV = dF[na:, na:]
            dFC = dF[:nc, :nc]
            zac = za[:nc, :]  # CV(alpha) rows
            zbv = zb[:, no:]  # CV(beta) columns
            coup_a = (f1 * torch.einsum("ib,ab->ia", zac, dFV)
                      + f2 * torch.einsum("ja,ij->ia", zac, dFC))
            cross_b = fx * (torch.einsum("ib,ab->ia", zbv, dFV)
                            + torch.einsum("ja,ij->ia", zbv, dFC))
            coup_b = (f2 * torch.einsum("ib,ab->ia", zbv, dFV)
                      + f1 * torch.einsum("ja,ij->ia", zbv, dFC))
            cross_a = fx * (torch.einsum("ib,ab->ia", zac, dFV)
                            + torch.einsum("ja,ij->ia", zac, dFC))
            return (torch.einsum("ia,ia->", zac, coup_a - cross_b)
                    + torch.einsum("ia,ia->", zbv, coup_b - cross_a))

        if self.method == "xcis":
            za, zb = split(x)
            return a_form_u(za, zb) + da_form(za, zb)
        # xtdhf: only the A forms get dA (B has no one-electron part)
        zxa, zxb = split(x[:d_u])
        zya, zyb = split(x[d_u:])
        return (a_form_u(zxa, zxb) + da_form(zxa, zxb) + a_form_u(zya, zyb)
                + da_form(zya, zyb) + 2.0 * b_form_u(zxa, zxb, zya, zyb))

    # -- eigenstates ----------------------------------------------------------
    def _driver_states(self, nstates: int):
        """(e, X) from the port's drivers (dense), in this module's packed
        layout (the drivers' blocked vectors reordered to interleaved; the
        TDHF drivers' X+Y and X-Y to [X; Y])."""
        from xtddft_tpu_torch.methods import drivers as drv
        from xtddft_tpu_torch.response.spaces import order_interleaved2blocked

        mf, m = self.mf, self.method
        nc, no = self.nb, self.na - self.nb
        inv = np.argsort(order_interleaved2blocked(nc, no, self.nmo - self.na))

        def unblock(v):
            return np.asarray(v)[inv]

        def xy(xpy, xmy):
            return np.concatenate([0.5 * (xpy + xmy), 0.5 * (xpy - xmy)])

        if m in ("cis", "cis-triplet"):
            r = drv.TDA(mf, nstates=nstates, singlet=(m == "cis")).kernel()
            V = np.asarray(r.v)
        elif m in ("rtdhf", "rtdhf-triplet"):
            r = drv.TDHF(mf, nstates=nstates, singlet=(m == "rtdhf"), backend="dense").kernel()
            V = xy(np.asarray(r.v), np.asarray(r.v_xmy))
        elif m == "ucis":
            r = drv.UTDA(mf, nstates=nstates).kernel()
            V = unblock(r.v)
        elif m == "xcis":
            r = drv.XTDA(mf, nstates=nstates, backend="dense").kernel()
            V = unblock(r.v)
        elif m == "utdhf":
            r = drv.UTDHF(mf, nstates=nstates, backend="dense").kernel()
            V = xy(unblock(r.v), unblock(r.v_xmy))
        elif m == "xtdhf":
            r = drv.XTDHF(mf, nstates=nstates, backend="dense").kernel()
            V = xy(unblock(r.v), unblock(r.v_xmy))
        else:
            r = drv.SFTDA(mf, nstates=nstates, extype="up", method=self.sf_method,
                          backend="dense").kernel()
            V = np.asarray(r.v)
        return np.asarray(r.e)[:nstates], V[:, :nstates]

    def states(self, nstates: int = 5, source: str | None = None):
        """(e, X) of the excited states: 'hessian' (the dense eigenproblem of
        this module's form, A = 1/2 d2 omega/dX2) or 'driver' (the port's
        drivers, `_driver_states`); by default 'driver' where the batched
        Hessian's footprint xdim * nao^4 * 8 bytes passes 5e8, or for a
        meta-GGA, as in JAX.  TDHF methods return packed [X; Y] columns with
        X^T X - Y^T Y = 1 from the (A, B) pencil of the same form."""
        if source is None:
            footprint = self.xdim * float(self.env.nao) ** 4 * 8.0
            mgga = self.spec is not None and self.spec.needs_tau
            source = "driver" if (footprint > 5e8 or mgga) else "hessian"
        if source == "driver":
            return self._driver_states(nstates)
        k0 = torch.zeros(self.nk, dtype=self.dtype, device=self.device)
        ints0 = self._ints0()
        x0 = torch.zeros(self.xdim, dtype=self.dtype, device=self.device)
        H = 0.5 * torch.func.hessian(lambda x: self._omega_i(ints0, k0, x))(x0)
        if not self.is_tdhf:
            e, v = np.linalg.eigh(H.detach().cpu().numpy())
            return e[:nstates], v[:, :nstates]
        from xtddft_tpu_torch.response.tdhf import solve_casida

        # the Hessian of omega[X, Y] is [[2A, 2B], [2B, 2A]]
        H = H.detach()
        d = self.xdim // 2
        e, xpy, xmy = solve_casida(H[:d, :d], H[:d, d:], nstates)
        return e, np.concatenate([0.5 * (xpy + xmy), 0.5 * (xpy - xmy)], axis=0)

    # -- the gradient ---------------------------------------------------------
    def kernel(self, state: int = 0, nstates: int | None = None, cg_tol: float = 1e-9,
               verbose: bool = False):
        """(natm, 3) gradient of E_scf + omega_state, and omega_state:
        returns (grad, omega)."""
        sync = (torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None))
        st = self.stats = {}

        def lap(name, t0):
            sync()
            st[name] = time.perf_counter() - t0
            if verbose:
                print(f"  [grad] {name}: {st[name]:.2f} s", flush=True)
            return time.perf_counter()

        t0 = time.perf_counter()
        e, v = self.states(state + 1 if nstates is None else nstates)
        t0 = lap("states_s", t0)
        x = torch.as_tensor(v[:, state], dtype=self.dtype, device=self.device)
        k0 = torch.zeros(self.nk, dtype=self.dtype, device=self.device)
        ints0 = self._ints0()
        t0 = lap("ints0_s", t0)
        b = torch.func.grad(lambda k: self._omega_i(ints0, k, x))(k0)
        t0 = lap("zvector_rhs_s", t0)
        gk = torch.func.grad(lambda k: self._e_elec(ints0, k))

        def hvp(vv):
            return torch.func.jvp(gk, (k0,), (vv,))[1]

        z, st["cg_iterations"] = _cg(hvp, b, tol=cg_tol, maxiter=400)
        t0 = lap("zvector_cg_s", t0)

        coords = self._coords(requires_grad=True)
        kk = k0.clone().requires_grad_(True)
        ints = self._ints(coords)
        e_el = self._e_elec(ints, kk)
        g_k = torch.autograd.grad(e_el, kk, create_graph=True)[0]
        phi = (e_el + _nuclear_repulsion(coords, self.charges) + self._omega_i(ints, k0, x)
               - torch.dot(z, g_k))
        g = torch.autograd.grad(phi, coords)[0]
        lap("phi_grad_s", t0)
        return g.detach().cpu().numpy(), float(e[state])


def scf_gradient(mf) -> np.ndarray:
    """(natm, 3) analytic ground-state gradient: the coordinate gradient of
    E_scf(R, kappa=0); SCF stationarity removes the orbital response and
    the Cholesky connection carries the Pulay terms."""
    eg = ExcitedGradients(mf, method="cis")  # the method only shapes the X space
    coords = eg._coords(requires_grad=True)
    k0 = torch.zeros(eg.nk, dtype=eg.dtype, device=eg.device)
    return torch.autograd.grad(eg._e_scf(coords, k0), coords)[0].detach().cpu().numpy()

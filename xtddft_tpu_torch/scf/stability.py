"""SCF internal stability analysis + stable-SCF retry loop.

Counterpart of the JAX package's `scf/stability.py`.  The reference guards
its SOC pipeline with PySCF's stability loop (`x2c_hamiltonian/
test_SOCSI.py:20-27`): after the SCF, check the internal stability of the
solution; if the orbital Hessian has a negative eigenvalue, rotate along
that direction and reconverge, up to a retry cap.

The Hessian is H = d2 E_elec / dkappa2 over the nonredundant rotation pairs
(occ-vir per spin for UHF; closed-open, closed-vir and open-vir for ROHF;
occ-vir for RHF), with C(kappa) = C0 expm(K(kappa)).  Two backends:

  dense -- ``torch.func.hessian`` of the SCF energy over the in-core ERIs
           and the Env's grid (plain torch; at most 140 AO);
  df    -- matrix-free: the energy of the JAX package's DF functional (hcore,
           J and K from the metric-dressed B, RSH K_lr from the
           erf-attenuated B, XC on the Env's grid), its Hessian actions
           from the chain rule, H v = (d2D/dkappa2 [v])^T F0 + (dD/dkappa)^T
           dF[dD v].  The orbital part (the first term, and dD and its
           transpose) is ``torch.func`` on nmo x nmo matrices; the Fock
           response dF is one Fock build on the stacked tangent densities of
           the whole batch: K1 `df_exchange` in AO mode and the Coulomb GEMM
           (J, K; a second exchange-only K1 pass for K_lr), K2 hermitian,
           the functional's ``torch.func`` jvp and K3 on the AO table
           (`xc/interface.py fxc_v1mat`).  F0 is one Fock build at the
           reference (`vxc_matrices` for the XC term).  The lowest
           eigenpairs come from the block Davidson.  Because everything is
           evaluated at the reference geometry, fixed-matrix hcore terms
           (the sfX2C picture change, v_ext) are exact here.
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.kernels.df_exchange import df_exchange
from xtddft_tpu_torch.xc import interface as xci

__all__ = ["internal_stability", "stable_scf", "df_hessian_operator"]

DENSE_MAX_NAO = 140


def _rot_pairs(kind: str, nmo: int, na: int, nb: int):
    """Nonredundant orbital-rotation index pairs (rows, cols) (JAX
    `grad/lagrangian.py:72`).

    rhf: occ-vir; rohf: closed-open, closed-vir, open-vir (the three
    variational spaces of the Roothaan solution); uhf: per-spin occ-vir
    (two stacked pair sets, the kappa vector is their concatenation)."""
    if kind in ("rhf", "rks"):
        pi, pj = np.meshgrid(np.arange(nb), np.arange(nb, nmo), indexing="ij")
        return [(pi.ravel(), pj.ravel())]
    if kind in ("rohf", "roks"):
        pairs = []
        c, o, v = np.arange(nb), np.arange(nb, na), np.arange(na, nmo)
        for rows, cols in ((c, o), (c, v), (o, v)):
            if len(rows) and len(cols):
                pi, pj = np.meshgrid(rows, cols, indexing="ij")
                pairs.append((pi.ravel(), pj.ravel()))
        return [tuple(np.concatenate(x) for x in zip(*pairs))]
    if kind in ("uhf", "uks"):
        out = []
        for n in (na, nb):
            pi, pj = np.meshgrid(np.arange(n), np.arange(n, nmo), indexing="ij")
            out.append((pi.ravel(), pj.ravel()))
        return out
    raise ValueError(kind)


def _rotate(C, kvec, pairs, nmo):
    """C expm(K), K antisymmetric with K[i, j] = kappa on the pairs (JAX
    `grad/lagrangian.py:112`)."""
    r = torch.as_tensor(pairs[0], device=C.device)
    c = torch.as_tensor(pairs[1], device=C.device)
    K = torch.zeros((nmo, nmo), dtype=C.dtype, device=C.device)
    K = K.index_put((r, c), kvec).index_put((c, r), -kvec, accumulate=True)
    return C @ torch.linalg.matrix_exp(K)


class _Orbitals:
    """The mean field's orbitals, rotation pairs and the densities
    D_s(kappa) = C_s(kappa)[:, :n_s] C_s(kappa)[:, :n_s]^T, (2, nao, nao)."""

    def __init__(self, mf):
        env = mf.env
        self.kind = mf.kind
        self.na, self.nb = mf.mol.nalpha, mf.mol.nbeta
        if mf.is_unrestricted:
            self.C0 = [env.tensor(mf.mo_coeff[0]), env.tensor(mf.mo_coeff[1])]
            self.eps = [np.asarray(mf.mo_energy[0]), np.asarray(mf.mo_energy[1])]
        else:
            self.C0 = [env.tensor(mf.mo_coeff)]
            self.eps = [np.asarray(mf.mo_energy)]
        self.nmo = self.C0[0].shape[1]
        self.pairs = _rot_pairs(self.kind, self.nmo, self.na, self.nb)
        self.nk = sum(len(p[0]) for p in self.pairs)

    def orbs(self, kvec):
        if self.kind in ("uhf", "uks"):
            n0 = len(self.pairs[0][0])
            return (_rotate(self.C0[0], kvec[:n0], self.pairs[0], self.nmo),
                    _rotate(self.C0[1], kvec[n0:], self.pairs[1], self.nmo))
        C = _rotate(self.C0[0], kvec, self.pairs[0], self.nmo)
        return C, C

    def dens(self, kvec):
        Ca, Cb = self.orbs(kvec)
        Coa, Cob = Ca[:, :self.na], Cb[:, :self.nb]
        return torch.stack([Coa @ Coa.T, Cob @ Cob.T])

    def hdiag(self) -> np.ndarray:
        """The orbital-energy-difference preconditioner 2 (e_j - e_i)."""
        return np.concatenate([2.0 * (self.eps[min(ch, len(self.eps) - 1)][pj]
                                      - self.eps[min(ch, len(self.eps) - 1)][pi])
                               for ch, (pi, pj) in enumerate(self.pairs)])

    def rotate(self, kvec) -> np.ndarray:
        """Displaced MO coefficients in the mean field's own layout."""
        kvec = torch.as_tensor(np.asarray(kvec), dtype=self.C0[0].dtype,
                               device=self.C0[0].device)
        Ca, Cb = self.orbs(kvec)
        if self.kind in ("uhf", "uks"):
            return np.stack([Ca.cpu().numpy(), Cb.cpu().numpy()])
        return Ca.cpu().numpy()


def _xc_terms(spec):
    hyb, hyb_lr, omega = 1.0, 0.0, 0.0
    if spec is not None:
        hyb = spec.hyb
        if abs(spec.omega) > 1e-12:
            omega = spec.omega
            hyb_lr = spec.alpha - spec.hyb
    return hyb, hyb_lr, omega


def _hcore(mf):
    h = mf.env.hcore
    if getattr(mf, "v_ext", None) is not None:
        h = h + mf.env.tensor(mf.v_ext)
    return h


def df_hessian_operator(mf):
    """Matrix-free internal-orbital-Hessian operator of the DF energy.

    Returns ``(hvp, hdiag, rotate)``: ``hvp(xs)`` applies H to a stacked
    batch (nv, nk) of kappa vectors (a tensor on the Env's device; numpy or
    a tensor in), with one Fock build of the kernels for the whole batch;
    ``hdiag`` is the orbital-energy-difference preconditioner; and
    ``rotate(kvec)`` maps a kappa vector to displaced MO coefficients in
    the mean field's own layout (JAX `scf/stability.py:40`)."""
    env = mf.env
    orb = _Orbitals(mf)
    spec = mf.xc
    hyb, hyb_lr, omega = _xc_terms(spec)
    B = env.df_B(0.0)
    B_lr = env.df_B(omega) if hyb_lr != 0.0 else None
    naux, nao = B.shape[0], B.shape[1]
    hcore = _hcore(mf)
    xc = spec is not None and bool(spec.components)
    mgga = xc and spec.needs_tau
    z = torch.zeros(orb.nk, dtype=env.dtype, device=env.device)
    D0 = orb.dens(z)

    def jk(dms):
        """(J of each pair of spin densities, K_s of each density): K1 in AO
        mode and the Coulomb GEMM (t by GEMMs alone without exchange), and a
        second, exchange-only K1 pass for the long range."""
        nv = dms.shape[0] // 2
        K = None
        if hyb != 0.0:
            t, K = df_exchange(B, dms, 0, 0, with_t=True)
            K = hyb * K
        else:
            t = dms.reshape(2 * nv, -1) @ B.reshape(naux, -1).T
        J = (t.reshape(nv, 2, naux).sum(1) @ B.reshape(naux, -1)).reshape(nv, 1, nao, nao)
        if hyb_lr != 0.0:
            klr = hyb_lr * df_exchange(B_lr, dms, 0, 0, with_t=False)[1]
            K = klr if K is None else K + klr
        G = J.expand(nv, 2, nao, nao)
        return G if K is None else G - K.reshape(nv, 2, nao, nao)

    rho0 = None
    F0 = hcore + jk(D0)[0]
    if xc:
        r, g, *t = xci.cache_rho(env.ao, D0, tau=mgga)
        rho0 = (r[0], r[1], g[0], g[1]) + ((t[0][0], t[0][1]) if mgga else ())
        _, va, vb = xci.vxc_matrices(spec, env.ao, env.grid_weights, rho0)
        F0 = F0 + torch.stack([va, vb])

    def phi(kvec):
        return torch.sum(F0 * orb.dens(kvec))

    second = torch.func.vmap(lambda v: torch.func.jvp(torch.func.grad(phi), (z,), (v,))[1])
    tangent = torch.func.vmap(lambda v: torch.func.jvp(orb.dens, (z,), (v,))[1])
    _, dens_vjp = torch.func.vjp(orb.dens, z)
    transpose = torch.func.vmap(lambda G: dens_vjp(G)[0])

    def hvp(xs):
        xs = torch.as_tensor(xs, dtype=env.dtype, device=env.device)
        hvp.calls += 1
        hvp.vectors += xs.shape[0]
        dD = tangent(xs)  # (nv, 2, nao, nao)
        dD = 0.5 * (dD + dD.transpose(-1, -2))
        G = jk(dD.reshape(-1, nao, nao))
        if xc:
            G = G + xci.fxc_v1mat(spec, env.ao, env.grid_weights, rho0, dD, hermi=True)
        return second(xs) + transpose(G)

    hvp.calls = hvp.vectors = 0  # Hessian actions (one Fock build each) and vectors
    return hvp, orb.hdiag(), orb.rotate


def _internal_stability_df(mf, tol: float, record: dict | None):
    """Lowest internal-Hessian eigenpair by block Davidson over DF Hessian
    actions, with the JAX arguments (3 roots, residual 1e-5, space factor
    30, 200 cycles; four cycles without a 2% drop of the largest residual
    end it, as they end the JAX host Davidson)."""
    from xtddft_tpu_torch.solver.davidson import davidson

    hvp, hdiag, rotate = df_hessian_operator(mf)
    w, V, conv, info = davidson(hvp, hdiag, nroots=min(3, hdiag.shape[0]), tol=1e-5,
                                max_cycle=200, max_space_factor=30,
                                device=mf.env.device, dtype=mf.env.dtype)
    if record is not None:
        record.update(w=w, converged=conv, hessian_actions=hvp.calls, vectors=hvp.vectors,
                      **info)
    w_min = float(w[0])
    if w_min > -tol:
        return True, w_min, mf.mo_coeff
    v0 = V[:, 0]
    return False, w_min, rotate((np.pi / 8.0) * v0 / np.abs(v0).max())


def _dense_energy_fn(mf):
    """(e(kappa), orbitals): the SCF electronic energy as a differentiable
    torch function of kappa, over the in-core ERIs (Coulomb and, for RSH,
    the erf-attenuated ones) and the Env's grid (the density by plain
    einsums, masked as the JAX quadrature masks it)."""
    env = mf.env
    orb = _Orbitals(mf)
    spec = mf.xc
    hyb, hyb_lr, omega = _xc_terms(spec)
    h = _hcore(mf)
    n = env.nao
    eri = env.eri.reshape(n * n, n * n)
    eri_k = env.eri_k(0.0)
    eri_k_lr = env.eri_k(omega) if hyb_lr != 0.0 else None
    xc = spec is not None and bool(spec.components)
    if xc:
        efn = xci.exc_density_fn(spec)
        ao, dao = env.ao[0], env.ao[1:4]
        w = env.grid_weights

    def ek(X, D):
        return torch.sum(D.reshape(-1) * (X @ D.reshape(-1)))

    def e(kvec):
        D = orb.dens(kvec)
        dt = D[0] + D[1]
        out = torch.sum(h * dt) + 0.5 * torch.sum(dt.reshape(-1) * (eri @ dt.reshape(-1)))
        out = out - 0.5 * hyb * (ek(eri_k, D[0]) + ek(eri_k, D[1]))
        if eri_k_lr is not None:
            out = out - 0.5 * hyb_lr * (ek(eri_k_lr, D[0]) + ek(eri_k_lr, D[1]))
        if xc:
            ra = torch.einsum("gp,pq,gq->g", ao, D[0], ao)
            rb = torch.einsum("gp,pq,gq->g", ao, D[1], ao)
            ga = 2.0 * torch.einsum("dgp,pq,gq->dg", dao, D[0], ao)
            gb = 2.0 * torch.einsum("dgp,pq,gq->dg", dao, D[1], ao)
            rho = (ra, rb, ga, gb)
            if spec.needs_tau:
                rho = rho + tuple(0.5 * torch.einsum("dgp,pq,dgq->g", dao, Ds, dao) for Ds in D)
            wm, rho_s, _ = xci._sanitize(w, rho)
            out = out + torch.sum(wm * efn(*rho_s))
        return out

    return e, orb


def internal_stability(mf, tol: float = 1e-6, backend: str = "auto",
                       record: dict | None = None):
    """(stable, w_min, mo_rotated): the lowest eigenvalue of the real
    internal orbital Hessian of a converged SCF solution.

    If unstable (w_min < -tol), ``mo_rotated`` holds orbitals displaced
    along the downhill eigenvector (step pi/8 in rotation angle, scaled by
    its largest element), an initial guess for a reconverge; otherwise it
    is the input orbitals.

    backend: 'dense' (``torch.func.hessian`` over in-core ERIs, at most 140
    AO), 'df' (the matrix-free Davidson over DF Hessian actions, any size),
    or 'auto': DF above 140 AO or with an x2c core Hamiltonian or v_ext, as
    in JAX, dense otherwise.  ``record`` (a dict) receives the DF backend's
    eigenvalues, convergence, Davidson cycles and Hessian actions."""
    if backend == "auto":
        special_h = (getattr(mf.env, "x2c", False)
                     or getattr(mf, "v_ext", None) is not None)
        backend = "df" if (mf.env.nao > DENSE_MAX_NAO or special_h) else "dense"
    if backend == "df":
        return _internal_stability_df(mf, tol, record)
    if backend != "dense":
        raise ValueError(f"backend {backend!r}: expected 'auto', 'dense' or 'df'")
    if mf.env.nao > DENSE_MAX_NAO:
        raise NotImplementedError(
            f"internal_stability(backend='dense') uses in-core ERIs; "
            f"nao={mf.env.nao} > {DENSE_MAX_NAO} would materialize an O(nao^4) "
            "tensor. Use backend='df' (matrix-free DF Hessian actions).")
    e, orb = _dense_energy_fn(mf)
    z = torch.zeros(orb.nk, dtype=mf.env.dtype, device=mf.env.device)
    H = torch.func.hessian(e)(z).cpu().numpy()
    H = 0.5 * (H + H.T)
    w, V = np.linalg.eigh(H)
    w_min = float(w[0])
    if w_min > -tol:
        return True, w_min, mf.mo_coeff
    return False, w_min, orb.rotate((np.pi / 8.0) * V[:, 0] / np.abs(V[:, 0]).max())


def stable_scf(scf, occ=None, init=None, max_tries: int = 3,
               tol: float = 1e-6, verbose: bool = False,
               backend: str = "auto"):
    """Converge an SCF and retry from rotated orbitals until internally
    stable (the reference's `test_SOCSI.py:20-27` loop).  Returns the
    final MeanField; raises if still unstable after ``max_tries``."""
    mf = scf.kernel(occ=occ, init=init)
    for it in range(max_tries):
        stable, w_min, mo = internal_stability(mf, tol=tol, backend=backend)
        if verbose:
            print(f"stability[{it}]: w_min={w_min:.3e} stable={stable}")
        if stable and mf.converged:
            return mf
        mf = scf.kernel(occ=occ, init=mo)
    stable, w_min, _ = internal_stability(mf, tol=tol, backend=backend)
    if not (stable and mf.converged):
        raise RuntimeError(
            f"SCF not stable after {max_tries} retries (w_min={w_min:.3e})")
    return mf

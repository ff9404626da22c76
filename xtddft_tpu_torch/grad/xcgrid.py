"""Differentiable XC quadrature: E_xc as a torch function of the nuclear
coordinates and the density matrices.

Counterpart of the JAX package's `grad/xcgrid.py`.  The host grid
(`grids/becke.py`, `grids/eval_ao.py`) computes fixed arrays at a fixed
geometry; here the same Becke fuzzy-cell scheme (atom-centred points that
move with their atom, smooth partition weights, Bragg-Slater size
adjustment) and the same AO evaluation are torch functions of the
coordinates, so that autograd gives the grid's Pulay terms (dw/dR and the
moving points) of any KS energy.  At the reference geometry it agrees with
the host grid.

By design, as in JAX: no |w| < 1e-14 point pruning (the extra points carry
~zero weight), and the densities are masked at `xc/interface.py`'s
MASK_RHO so that functional derivatives stay finite where rho ~ 0.

Plain torch: the Lagrangian differentiates E_xc to third order (the fxc
term is a second derivative along the transition density, then its
coordinate gradient), and the grid kernels K2 and K3 have no
differentiable backward.  Each function made here also takes the grid
directly (``.on_grid(grid_ao(coords), ...)``, ``.grid_ao``), so that a
caller can evaluate the grid once per geometry outside any ``torch.func``
transform (the orbital-space derivatives at the reference geometry).
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch import units
from xtddft_tpu_torch.grids import angular, radial
from xtddft_tpu_torch.grids.becke import _BRAGG, _becke_smooth
from xtddft_tpu_torch.ints.shell import BasisLayout, cart2sph, cart_components
from xtddft_tpu_torch.xc import interface as xci
from xtddft_tpu_torch.xc.interface import MASK_RHO, exc_density_fn
from xtddft_tpu_torch.xc.registry import XCSpec

__all__ = ["make_exc_fn", "make_sf_alda0_fn", "make_sf_mcol_fn"]


def _make_grid_ao(mol, layout: BasisLayout, level: int = 1):
    """Return ``grid_ao(coords) -> (w, ao, dao)`` over the moving
    atom-centred quadrature: weights (ng,), AO values (ng, nao) and their
    gradients (3, ng, nao) on coords' device and dtype."""
    natm = mol.natm
    z = np.asarray(mol.charges, dtype=int)
    sph_pts, sph_wts = angular.sphere_grid(angular.default_degree(level))
    local_pts, w0, atom_idx = [], [], []
    for ia in range(natm):
        r, wr = radial.treutler_ahlrichs(radial.default_nrad(int(z[ia]), level), int(z[ia]))
        local_pts.append((r[:, None, None] * sph_pts[None, :, :]).reshape(-1, 3))
        w0.append((wr[:, None] * r[:, None] ** 2 * sph_wts[None, :]).reshape(-1))
        atom_idx.append(np.full(local_pts[-1].shape[0], ia))
    local_pts = np.concatenate(local_pts)
    w0 = np.concatenate(w0)
    atom_idx = np.concatenate(atom_idx)
    rad_bragg = np.array([_BRAGG[min(zi, len(_BRAGG) - 1)] for zi in z]) * units.ANG2BOHR
    shells = [(sh.l, sh.exps, sh.coefs, sh.atom_index) for sh in layout.shells]
    consts = {}

    def on(like):
        key = (like.device, like.dtype)
        if key not in consts:
            def t(x):
                return torch.as_tensor(x, dtype=like.dtype, device=like.device)
            consts[key] = dict(
                local=t(local_pts), w0=t(w0), idx=torch.as_tensor(atom_idx, device=like.device),
                sh=[(l, t(e), t(c), ia, t(cart2sph(l))) for l, e, c, ia in shells])
        return consts[key]

    def becke_w(pts, coords, k):
        if natm == 1:
            return torch.ones_like(pts[:, 0])
        d = torch.linalg.norm(pts[:, None, :] - coords[None, :, :] + 1e-300, dim=2)
        eye = torch.eye(natm, dtype=coords.dtype, device=coords.device)
        rij = torch.linalg.norm(coords[:, None, :] - coords[None, :, :] + eye[:, :, None], dim=2)
        cols = []
        for i in range(natm):
            Pi = torch.ones_like(d[:, 0])
            for j in range(natm):
                if i == j:
                    continue
                mu = (d[:, i] - d[:, j]) / rij[i, j]
                chi = rad_bragg[i] / rad_bragg[j]
                u = (chi - 1.0) / (chi + 1.0)
                a = float(np.clip(u / (u ** 2 - 1.0), -0.5, 0.5))
                mu = mu + a * (1.0 - mu ** 2)
                Pi = Pi * (0.5 * (1.0 - _becke_smooth(mu)))
            cols.append(Pi)
        P = torch.stack(cols, dim=1)
        return P.gather(1, k["idx"][:, None])[:, 0] / P.sum(dim=1)

    def eval_ao(pts, coords, k):
        aos, daos = [], [[], [], []]
        for l, exps, coefs, ia, C in k["sh"]:
            r = pts - coords[ia][None, :]
            r2 = torch.einsum("gd,gd->g", r, r)
            expv = torch.exp(-exps[None, :] * r2[:, None]) * coefs[None, :]
            radv = expv.sum(dim=1)
            dradv = -2.0 * (expv * exps[None, :]).sum(dim=1)
            comps = cart_components(l)
            mono = torch.stack([r[:, 0] ** i * r[:, 1] ** j * r[:, 2] ** kk
                                for (i, j, kk) in comps], dim=1)
            aos.append((mono * radv[:, None]) @ C)
            for dax in range(3):
                dm = []
                for e in comps:
                    if e[dax] > 0:
                        em = list(e)
                        em[dax] -= 1
                        dm.append(e[dax] * r[:, 0] ** em[0] * r[:, 1] ** em[1] * r[:, 2] ** em[2])
                    else:
                        dm.append(torch.zeros_like(r2))
                cart_d = torch.stack(dm, dim=1) * radv[:, None] \
                    + mono * (dradv * r[:, dax])[:, None]
                daos[dax].append(cart_d @ C)
        return torch.cat(aos, dim=1), torch.stack([torch.cat(d, dim=1) for d in daos])

    def grid_ao(coords):
        k = on(coords)
        pts = coords[k["idx"]] + k["local"]
        w = k["w0"] * becke_w(pts, coords, k)
        ao, dao = eval_ao(pts, coords, k)
        return w, ao, dao

    return grid_ao


def _with_grid(fn, grid_ao):
    """``f(coords, *args)`` from ``fn(grid, *args)``, with ``.on_grid`` and
    ``.grid_ao`` attached."""
    def f(coords, *args):
        return fn(grid_ao(coords), *args)

    f.on_grid, f.grid_ao = fn, grid_ao
    return f


def _rho_terms(w, ao, dao, Da, Db):
    ra = torch.einsum("gp,pq,gq->g", ao, Da, ao)
    rb = torch.einsum("gp,pq,gq->g", ao, Db, ao)
    ga = 2.0 * torch.einsum("dgp,pq,gq->dg", dao, Da, ao)
    gb = 2.0 * torch.einsum("dgp,pq,gq->dg", dao, Db, ao)
    return ra, rb, ga, gb


def make_exc_fn(mol, layout: BasisLayout, spec: XCSpec, level: int = 1):
    """Return ``exc(coords, Da, Db) -> scalar`` (hartree), differentiable in
    all three.  A meta-GGA's tau_s = 1/2 grad(phi).D_s.grad(phi) is formed
    inside from the density matrices, so every tau response term (in the
    Fock, the fxc blocks and the Pulay forces) follows by autodiff."""
    grid_ao = _make_grid_ao(mol, layout, level)
    edens = exc_density_fn(spec)
    needs_tau = spec.needs_tau

    def exc(grid, Da, Db):
        w, ao, dao = grid
        ra, rb, ga, gb = _rho_terms(w, ao, dao, Da, Db)
        mask = (ra > MASK_RHO) | (rb > MASK_RHO)
        one = torch.ones((), dtype=ra.dtype, device=ra.device)
        zero = torch.zeros((), dtype=ra.dtype, device=ra.device)
        args = (torch.where(mask, ra, one), torch.where(mask, rb, one),
                torch.where(mask[None, :], ga, zero), torch.where(mask[None, :], gb, zero))
        if needs_tau:
            # the benign-tau masking of xc/interface.py:_sanitize
            ta = 0.5 * torch.einsum("dgp,pq,dgq->g", dao, Da, dao)
            tb = 0.5 * torch.einsum("dgp,pq,dgq->g", dao, Db, dao)
            args = args + (torch.where(mask, ta, one), torch.where(mask, tb, one))
        return torch.sum(torch.where(mask, w, zero) * edens(*args))

    return _with_grid(exc, grid_ao)


def make_sf_alda0_fn(mol, layout: BasisLayout, spec: XCSpec, level: int = 1):
    """Return ``sf_term(coords, Da, Db, T) -> scalar``: the ALDA0 spin-flip
    xc contribution sum_g w f_sf(g) rho_T(g)^2 of the SF-TDA quadratic form,
    differentiable in the coordinates."""
    grid_ao = _make_grid_ao(mol, layout, level)

    def sf_term(grid, Da, Db, T):
        w, ao, dao = grid
        fw = xci.sf_kernel_alda0(spec, w, _rho_terms(w, ao, dao, Da, Db))
        rt = torch.einsum("gp,pq,gq->g", ao, T, ao)
        return torch.sum(fw * rt * rt)

    return _with_grid(sf_term, grid_ao)


def make_sf_mcol_fn(mol, layout: BasisLayout, spec: XCSpec, level: int = 1, nt: int = 20):
    """Return ``sf_term(coords, Da, Db, T) -> scalar``: the multicollinear
    spin-flip xc contribution sum_g s(g) . H_mc(g) . s(g), s = (rho_T, grad
    rho_T[, tau_T]) of the alpha<-beta AO density T and H_mc the transverse
    multicollinear kernel (`xc/mcol.py sf_kernel_mcol`, itself torch.func),
    differentiable in the coordinates."""
    from xtddft_tpu_torch.xc.mcol import sf_kernel_mcol

    grid_ao = _make_grid_ao(mol, layout, level)

    def sf_term(grid, Da, Db, T):
        w, ao, dao = grid
        rho0 = _rho_terms(w, ao, dao, Da, Db)
        if spec.needs_tau:
            rho0 = rho0 + (0.5 * torch.einsum("xgp,pq,xgq->g", dao, Da, dao),
                           0.5 * torch.einsum("xgp,pq,xgq->g", dao, Db, dao))
        fxcH = sf_kernel_mcol(spec, w, rho0, nt=nt)  # (ng, 4[5], 4[5])
        rt = torch.einsum("gp,pq,gq->g", ao, T, ao)
        grt = torch.einsum("xgp,pq,gq->xg", dao, T, ao) + torch.einsum("gp,pq,xgq->xg", ao, T,
                                                                        dao)
        parts = [rt[None], grt]
        if spec.needs_tau:
            parts.append(0.5 * torch.einsum("xgp,pq,xgq->g", dao, T, dao)[None])
        sv = torch.cat(parts, dim=0)  # (4[5], ng)
        return torch.einsum("cg,gcd,dg->", sv, fxcH, sv)

    return _with_grid(sf_term, grid_ao)

"""Grid XC evaluation: densities, SCF potentials and the fxc response via torch.func.

Every functional is an energy density e(rho_a, rho_b, grad_rho_a,
grad_rho_b[, tau_a, tau_b]); then

    vxc      = grad(sum_g w e)          (SCF potential)
    fxc.rho1 = jvp(grad(sum_g w e))     (TDDFT kernel response)

(``torch.func.grad`` and its ``torch.func.jvp``), exact for LDA, GGA and
meta-GGA including all gamma cross terms.  Counterpart of the JAX package's
`xc/interface.py`.  The density on the grid (`cache_rho`) and the potential
matrix (`_contract_vmat`) are the hand-written kernels K2 (hermitian mode)
and K3 on the AO table when the tensors are on the card, their plain torch
versions on the CPU; on the card both sum in their fixed order, so that an
SCF's Fock build repeats bitwise.  The in-core response's XC terms
(`fxc_v1mat`, `sf_v1mat`) run on the same two kernels in their atomic order.

Density convention: ``rho = (ra, rb, ga, gb)`` with ra/rb shape (ng,) and
ga/gb shape (3, ng); a meta-GGA spec takes the 6-tuple ``(ra, rb, ga, gb,
ta, tb)`` with the spin kinetic-energy densities ta/tb (ng,), and its
potentials and responses carry the two tau channels after the four others
(K2's tau row, K3's tau term).
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels.grid_back import grid_back
from xtddft_tpu_torch.kernels.grid_rho1 import grid_rho1
from xtddft_tpu_torch.xc import functionals as fl
from xtddft_tpu_torch.xc.registry import XCSpec

MASK_RHO = 1e-11


def exc_density_fn(spec: XCSpec):
    """Return e(ra, rb, ga, gb[, ta, tb]) -> (ng,) energy density.  Meta-GGA
    specs take the two spin kinetic-energy densities; the LDA and GGA
    components of a meta-GGA composite ignore them."""
    comps = [(w, name in fl.MGGA_NAMES, fl.FUNCTIONALS[name]) for w, name in spec.components]

    def e(ra, rb, ga, gb, *taus):
        gaa = torch.einsum("xg,xg->g", ga, ga)
        gab = torch.einsum("xg,xg->g", ga, gb)
        gbb = torch.einsum("xg,xg->g", gb, gb)
        out = torch.zeros_like(ra)
        for w, mgga, f in comps:
            out = out + w * (f(ra, rb, gaa, gab, gbb, *taus) if mgga
                             else f(ra, rb, gaa, gab, gbb))
        return out

    return e


def symmetrize(dm):
    """(D + D^T) / 2 over the last two axes."""
    return 0.5 * (dm + dm.transpose(-1, -2))


def cache_rho(ao, dm, hermi: bool = True, mask=None, ncomp: int = 4, fixed_order: bool = True,
              tau: bool = False):
    """Density and gradient on the grid from AO values: K2 `grid_rho1` in
    its hermitian mode, one launch for a whole stack of matrices.

    ao: (4, ng, nao) [value, ddx, ddy, ddz]; dm: (nao, nao) or (nz, nao,
    nao).  Returns (rho (ng,), grho (3, ng)), with a leading nz axis for a
    stack; with ``ncomp=1`` grho is None.  ``tau`` appends the
    kinetic-energy density 1/2 sum_y (d_y phi) dm (d_y phi) (K2's fifth
    row; JAX `xc/interface.py:53`), which for any dm is that of D_s.  ``hermi=False`` (transition
    matrices, JAX `xc/interface.py:53`): with D_s = (D + D^T)/2,
    rho(D) = rho(D_s) and grad phi D phi + phi D grad phi = 2 grad phi D_s
    phi, which is what the hermitian mode returns for D_s, so D_s goes to
    the kernel.  ``mask`` (ng,) 0/1 zeroes the rows where it is 0.
    ``fixed_order`` (the SCF's density) sums each point in a fixed order;
    the in-core response passes False (the atomic order, as the DF sigma).
    """
    d = dm.reshape(-1, *dm.shape[-2:])
    if not hermi:
        d = symmetrize(d)
    if tau:
        ncomp = 5
    r = grid_rho1(ao, d, 0, 0, mask, ncomp=ncomp, hermi=True, fixed_order=fixed_order)
    if dm.dim() == 2:
        r = r[0]
    out = (r[..., 0, :], (r[..., 1:4, :] if ncomp >= 4 else None))
    return out + (r[..., 4, :],) if tau else out


def _sanitize(weights, rho):
    """Zero the quadrature weight AND replace the density by a benign value
    on negligible-density points.  Masking only the weights is not enough:
    autodiff of (0 * inf) produces NaN, so the functional must never see
    pathological inputs.  Takes the 4-tuple (LDA/GGA) or the 6-tuple
    (..., ta, tb) of a meta-GGA, whose masked points get tau = 1: with a
    zero gradient any positive tau gives z = 0 (JAX `xc/interface.py:72`)."""
    ra, rb, ga, gb, *taus = rho
    mask = (ra > MASK_RHO) | (rb > MASK_RHO)
    zero = torch.zeros((), dtype=ra.dtype, device=ra.device)
    one = torch.ones((), dtype=ra.dtype, device=ra.device)
    w = torch.where(mask, weights, zero)
    ra_s = torch.where(mask, ra, one)
    rb_s = torch.where(mask, rb, one)
    ga_s = torch.where(mask[None, :], ga, zero)
    gb_s = torch.where(mask[None, :], gb, zero)
    out = (ra_s, rb_s, ga_s, gb_s) + tuple(torch.where(mask, t, one) for t in taus)
    return w, out, mask


def eval_exc(spec: XCSpec, weights, rho):
    """Exchange-correlation energy sum_g w e on the sanitized densities."""
    w, rho_s, _ = _sanitize(weights, rho)
    return torch.sum(w * exc_density_fn(spec)(*rho_s))


def eval_vxc(spec: XCSpec, weights, rho):
    """Weighted potential derivatives (w * vrho_a, w * vrho_b, w * wvec_a,
    w * wvec_b[, w * vtau_a, w * vtau_b]), wvec = dE/d(grad rho) =
    2 vgaa*ga + vgab*gb; the tau derivatives for a meta-GGA's 6-tuple."""
    return _exc_and_vxc(spec, weights, rho)[1]


def _exc_and_vxc(spec: XCSpec, weights, rho):
    """(Exc, eval_vxc's four or six derivatives) from one ``torch.func``
    pass."""
    w, rho_s, _ = _sanitize(weights, rho)
    efn = exc_density_fn(spec)

    def total(*args):
        return torch.sum(w * efn(*args))

    dv, exc = torch.func.grad_and_value(total, argnums=tuple(range(len(rho_s))))(*rho_s)
    return exc, dv


def _contract_vmat(ao, wv, wvec, wtau=None, fixed_order: bool = True):
    """V_mu_nu = sum_g [wv phi phi + wvec . (grad(phi) phi + phi grad(phi))
    + wtau/2 grad(phi) . grad(phi)] (no tau term without ``wtau``): K3
    `grid_back` with the AO table on both sides, one launch for a stack.

    wv, wtau: (ng,) or (nz, ng); wvec: (3, ng) or (nz, 3, ng).  Returns
    (nao, nao), with a leading nz axis for a stack.  ``fixed_order``: as
    `cache_rho`'s.
    """
    dwv = wv.reshape(-1, wv.shape[-1])
    dwt = None if wtau is None else wtau.reshape(-1, wtau.shape[-1])
    out = torch.zeros((dwv.shape[0], ao.shape[2], ao.shape[2]), dtype=ao.dtype, device=ao.device)
    grid_back(dwv, wvec.reshape(-1, 3, wvec.shape[-1]), ao, 0, 0, out, fixed_order=fixed_order,
              dwt=dwt)
    return out[0] if wv.dim() == 1 else out


def vxc_matrices(spec: XCSpec, ao, weights, rho):
    """(Exc, Va, Vb) for the SCF Fock build: the functional and its
    derivatives in one ``torch.func`` pass, both potentials in one K3
    launch (with the tau term for a meta-GGA's 6-tuple)."""
    exc, dv = _exc_and_vxc(spec, weights, rho)
    wtau = torch.stack(dv[4:6]) if len(dv) == 6 else None
    V = _contract_vmat(ao, torch.stack(dv[0:2]), torch.stack(dv[2:4]), wtau)
    return exc, V[0], V[1]


def fxc_response(spec: XCSpec, weights, rho0):
    """(respond, mask): respond(drho) -> the weighted perturbed potentials
    (dwva, dwvb, dwga, dwgb[, dwta, dwtb]) of one transition density (dra,
    drb, dga, dgb[, dta, dtb]) by a jvp of the potential (JAX
    `xc/interface.py:138`); drho must be zero where ``mask`` (ng,) is
    false, as K2's masked rows are."""
    w, rho_s, mask = _sanitize(weights, rho0)
    jvp = make_fxc_jvp(spec)
    return (lambda drho: jvp(w, rho_s, drho)), mask


# (sets x grid points) per fxc jvp call of `fxc_v1mat`, as the DF sigma's
# `JVP_POINTS`
V1_JVP_POINTS = 1 << 20


def fxc_v1mat(spec: XCSpec, ao, weights, rho0, dm1s, hermi: bool = False):
    """Perturbed XC matrices for a batch of density matrices (JAX
    `xc/interface.py:168`): dm1s (nset, 2, nao, nao) alpha/beta, any
    symmetry with ``hermi=False``; returns (nset, 2, nao, nao).  One K2
    launch (hermitian mode on the symmetrized stack, masked) gives every
    transition density, with its tau row for a meta-GGA ``rho0`` (the
    6-tuple), the jvp runs over groups of sets, and one K3 launch on the AO
    table gives every matrix, with its tau term.  Both kernels sum in their atomic
    order, as the DF sigma's do: at CH2O+/cc-pVDZ's in-core stack the fixed
    order costs K2 8% and K3 37% (`chip_smoke.py` phase 2)."""
    nset, nao = dm1s.shape[0], dm1s.shape[-1]
    mgga = len(rho0) == 6
    respond, mask = fxc_response(spec, weights, rho0)
    r1, g1, *t1 = cache_rho(ao, dm1s.reshape(2 * nset, nao, nao), hermi=hermi,
                            mask=mask.to(ao.dtype), fixed_order=False, tau=mgga)
    r1 = r1.reshape(nset, 2, -1)
    g1 = g1.reshape(nset, 2, 3, -1)
    t1 = t1[0].reshape(nset, 2, -1) if mgga else None
    ng = r1.shape[-1]
    dwv = torch.empty_like(r1)
    dwg = torch.empty_like(g1)
    dwt = torch.empty_like(t1) if mgga else None
    group = max(1, V1_JVP_POINTS // ng)
    for x0 in range(0, nset, group):
        x = slice(x0, x0 + group)
        drho = (r1[x, 0], r1[x, 1], g1[x, 0], g1[x, 1])
        if mgga:
            drho = drho + (t1[x, 0], t1[x, 1])
        dv = torch.func.vmap(respond)(drho)
        dwv[x] = torch.stack(dv[0:2], dim=1)
        dwg[x] = torch.stack(dv[2:4], dim=1)
        if mgga:
            dwt[x] = torch.stack(dv[4:6], dim=1)
    V = _contract_vmat(ao, dwv.reshape(2 * nset, ng), dwg.reshape(2 * nset, 3, ng),
                       None if dwt is None else dwt.reshape(2 * nset, ng), fixed_order=False)
    return V.reshape(nset, 2, nao, nao)


def make_fxc_jvp(spec: XCSpec):
    """respond(w, rho_s, drho) -> (dwva, dwvb, dwga, dwgb[, dwta, dwtb]):
    the weighted fxc response to one transition density (the tau pair for
    a meta-GGA's 6-tuples, JAX `xc/interface.py:195`).  The caller
    sanitizes rho0 and masks drho (see `_sanitize`); batch over trial
    vectors with ``torch.func.vmap`` over ``drho``."""
    efn = exc_density_fn(spec)

    def respond(w, rho_s, drho):
        def total(*args):
            return torch.sum(w * efn(*args))

        vfun = torch.func.grad(total, argnums=tuple(range(len(rho_s))))
        _, dv = torch.func.jvp(vfun, tuple(rho_s), tuple(drho))
        return dv

    return respond


def sf_kernel_alda0(spec: XCSpec, weights, rho0):
    """ALDA0 spin-flip kernel, weight-included:

        fxc_sf(g) = w * (vxc_a - vxc_b) / (rho_a - rho_b + 1e-9)

    with vxc evaluated in the LDA limit (gradients zeroed for GGA).  The
    potentials see the sanitized densities; the denominator keeps the raw
    ones, as in the JAX package (the weight is zero on masked points, so
    the quotient is zero there whatever the denominator)."""
    if spec.needs_tau:
        raise NotImplementedError(
            "spin-flip kernels are not defined for MGGA functionals here")
    ra, rb, ga, _ = rho0[:4]
    w, (ra_s, rb_s, _, _), _ = _sanitize(weights, rho0)
    efn = exc_density_fn(spec)
    zg = torch.zeros_like(ga)

    def total(ra_, rb_):
        return torch.sum(w * efn(ra_, rb_, zg, zg))

    va, vb = torch.func.grad(total, argnums=(0, 1))(ra_s, rb_s)
    return (va - vb) / (ra - rb + 1e-9)


def sf_v1mat(ao, fxc_sf_w, dm1s):
    """SF response matrices v1 = sum_g fxc_sf_w rho1 phi phi (JAX
    `xc/interface.py:242`) for alpha->beta transition matrices dm1s (nset,
    nao, nao): the value row of K2 (hermitian mode on the symmetrized
    stack) and K3's value term on the AO table, one launch each, in their
    atomic order (as `fxc_v1mat`)."""
    rho1, _ = cache_rho(ao, dm1s, hermi=False, ncomp=1, fixed_order=False)
    out = torch.zeros_like(dm1s)
    grid_back(fxc_sf_w * rho1, None, ao, 0, 0, out)
    return out

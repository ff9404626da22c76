"""Grid XC evaluation: densities, SCF potentials and the fxc response via torch.func.

Every functional is an energy density e(rho_a, rho_b, grad_rho_a,
grad_rho_b); then

    vxc      = grad(sum_g w e)          (SCF potential)
    fxc.rho1 = jvp(grad(sum_g w e))     (TDDFT kernel response)

(``torch.func.grad`` and its ``torch.func.jvp``), exact for LDA and GGA
including all gamma cross terms.  Counterpart of the JAX package's
`xc/interface.py`.  The density on the grid (`cache_rho`) and the potential
matrix (`_contract_vmat`) are the hand-written kernels K2 (hermitian mode)
and K3 on the AO table when the tensors are on the card, their plain torch
versions on the CPU; on the card both sum in their fixed order, so that an
SCF's Fock build repeats bitwise.

Density convention: ``rho = (ra, rb, ga, gb)`` with ra/rb shape (ng,) and
ga/gb shape (3, ng).
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels.grid_back import grid_back
from xtddft_tpu_torch.kernels.grid_rho1 import grid_rho1
from xtddft_tpu_torch.xc import functionals as fl
from xtddft_tpu_torch.xc.registry import XCSpec

MASK_RHO = 1e-11


def exc_density_fn(spec: XCSpec):
    """Return e(ra, rb, ga, gb) -> (ng,) energy density."""
    if spec.needs_tau:
        raise NotImplementedError(
            f"{spec.name}: the meta-GGA tau channel is not ported yet "
            "(ROADMAP queue 1, item 3)")
    comps = [(w, fl.FUNCTIONALS[name]) for w, name in spec.components]

    def e(ra, rb, ga, gb):
        gaa = torch.einsum("xg,xg->g", ga, ga)
        gab = torch.einsum("xg,xg->g", ga, gb)
        gbb = torch.einsum("xg,xg->g", gb, gb)
        out = torch.zeros_like(ra)
        for w, f in comps:
            out = out + w * f(ra, rb, gaa, gab, gbb)
        return out

    return e


def cache_rho(ao, dm):
    """Density and gradient on the grid from AO values: K2 `grid_rho1` in
    its hermitian mode, one launch for a whole stack of matrices.

    ao: (4, ng, nao) [value, ddx, ddy, ddz]; dm: (nao, nao) or (nz, nao,
    nao), symmetric.  Returns (rho (ng,), grho (3, ng)), with a leading nz
    axis for a stack.
    """
    r = grid_rho1(ao, dm.reshape(-1, *dm.shape[-2:]), 0, 0, hermi=True, fixed_order=True)
    if dm.dim() == 2:
        r = r[0]
    return r[..., 0, :], r[..., 1:4, :]


def _sanitize(weights, rho):
    """Zero the quadrature weight AND replace the density by a benign value
    on negligible-density points.  Masking only the weights is not enough:
    autodiff of (0 * inf) produces NaN, so the functional must never see
    pathological inputs."""
    ra, rb, ga, gb = rho
    mask = (ra > MASK_RHO) | (rb > MASK_RHO)
    zero = torch.zeros((), dtype=ra.dtype, device=ra.device)
    one = torch.ones((), dtype=ra.dtype, device=ra.device)
    w = torch.where(mask, weights, zero)
    ra_s = torch.where(mask, ra, one)
    rb_s = torch.where(mask, rb, one)
    ga_s = torch.where(mask[None, :], ga, zero)
    gb_s = torch.where(mask[None, :], gb, zero)
    return w, (ra_s, rb_s, ga_s, gb_s), mask


def eval_exc(spec: XCSpec, weights, rho):
    """Exchange-correlation energy sum_g w e on the sanitized densities."""
    w, rho_s, _ = _sanitize(weights, rho)
    return torch.sum(w * exc_density_fn(spec)(*rho_s))


def eval_vxc(spec: XCSpec, weights, rho):
    """Weighted potential derivatives (w * vrho_a, w * vrho_b, w * wvec_a,
    w * wvec_b), wvec = dE/d(grad rho) = 2 vgaa*ga + vgab*gb."""
    return _exc_and_vxc(spec, weights, rho)[1]


def _exc_and_vxc(spec: XCSpec, weights, rho):
    """(Exc, eval_vxc's four derivatives) from one ``torch.func`` pass."""
    w, rho_s, _ = _sanitize(weights, rho)
    efn = exc_density_fn(spec)

    def total(*args):
        return torch.sum(w * efn(*args))

    dv, exc = torch.func.grad_and_value(total, argnums=(0, 1, 2, 3))(*rho_s)
    return exc, dv


def _contract_vmat(ao, wv, wvec):
    """V_mu_nu = sum_g [wv phi phi + wvec . (grad(phi) phi + phi grad(phi))]:
    K3 `grid_back` with the AO table on both sides, one launch for a stack.

    wv: (ng,) or (nz, ng); wvec: (3, ng) or (nz, 3, ng).  Returns (nao,
    nao), with a leading nz axis for a stack.
    """
    dwv = wv.reshape(-1, wv.shape[-1])
    out = torch.zeros((dwv.shape[0], ao.shape[2], ao.shape[2]), dtype=ao.dtype, device=ao.device)
    grid_back(dwv, wvec.reshape(-1, 3, wvec.shape[-1]), ao, 0, 0, out, fixed_order=True)
    return out[0] if wv.dim() == 1 else out


def vxc_matrices(spec: XCSpec, ao, weights, rho):
    """(Exc, Va, Vb) for the SCF Fock build: the functional and its
    derivatives in one ``torch.func`` pass, both potentials in one K3
    launch."""
    exc, (wva, wvb, wga, wgb) = _exc_and_vxc(spec, weights, rho)
    V = _contract_vmat(ao, torch.stack([wva, wvb]), torch.stack([wga, wgb]))
    return exc, V[0], V[1]


def make_fxc_jvp(spec: XCSpec):
    """respond(w, rho_s, drho) -> (dwva, dwvb, dwga, dwgb): the weighted
    fxc response to one transition density.  The caller sanitizes rho0 and
    masks drho (see `_sanitize`); batch over trial vectors with
    ``torch.func.vmap`` over ``drho``."""
    efn = exc_density_fn(spec)

    def respond(w, rho_s, drho):
        def total(ra, rb, ga, gb):
            return torch.sum(w * efn(ra, rb, ga, gb))

        vfun = torch.func.grad(total, argnums=(0, 1, 2, 3))
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

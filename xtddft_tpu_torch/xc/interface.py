"""Grid XC evaluation: densities on the grid and the fxc response via torch.func.

Every functional is an energy density e(rho_a, rho_b, grad_rho_a,
grad_rho_b); the TDDFT kernel response is

    fxc . rho1 = jvp(grad(sum_g w e))

(``torch.func.jvp`` of ``torch.func.grad``), exact for LDA and GGA including
all gamma cross terms.  Counterpart of the JAX package's `xc/interface.py`.

Density convention: ``rho = (ra, rb, ga, gb)`` with ra/rb shape (ng,) and
ga/gb shape (3, ng).
"""

from __future__ import annotations

import torch

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
    """Density and gradient on the grid from AO values.

    ao: (4, ng, nao) [value, ddx, ddy, ddz]; dm: (nao, nao) symmetric.
    Returns (rho (ng,), grho (3, ng)).
    """
    t = ao[0] @ dm  # (ng, nao)
    rho = torch.einsum("gj,gj->g", t, ao[0])
    grho = 2.0 * torch.einsum("xgi,gi->xg", ao[1:4], t)
    return rho, grho


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

"""Multicollinear spin-flip XC kernel (method=1, 'mcol') for LDA, GGA and meta-GGA specs.

Counterpart of the JAX package's `xc/mcol.py` (`_e_point_fn`,
`sf_kernel_mcol`).  The kernel is the closed form of the multicollinear
construction (Pu et al., Phys. Rev. Research 5, 013036):

    f^sf_ab(r) = 1/2 * int_{-1}^{1} dt  d^2 e_col / dsigma_a dsigma_b
                 evaluated at (n, grad n; s = t*m, grad s = t*grad m)

with sigma = (s, grad s) the collinear spin variables, and for a meta-GGA
also tau_s, sampled along t like (s, grad s) (JAX `xc/mcol.py:40-60`).
For LDA functionals it equals the ALDA0 kernel, and it is finite at
closed-shell points.

The per-point Hessian in the 4 (5) spin variables comes from torch.func autodiff
of the same energy density used everywhere else (`xc/interface`).  Grid
points are independent, so the Hessian of the summed energy density is
block diagonal and its column b is one jvp of the gradient along the unit
direction b on every point at once: the four (five) jvps of a batch of
(t-samples x points) run as one ``vmap`` over the directions (the primal
pass once), where the JAX code vmaps `jax.hessian` over the points.

The dense coupling tensor (`sf_mcol_tensor`) is one product over grid
chunks; the matrix-free response (`sf_v1mat_mcol`) runs on K2 (hermitian
mode on the symmetrized transition matrices) and K3 on the AO table.
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.kernels.grid_back import grid_back
from xtddft_tpu_torch.response.fxc_tensor import DENSE_CHUNK, mo_pair_features
from xtddft_tpu_torch.xc.interface import MASK_RHO, cache_rho, exc_density_fn
from xtddft_tpu_torch.xc.registry import XCSpec

# Grid points per Hessian batch (times nt samples): 187,644 points go in 6
# batches, 49,152 in 2; its time on the card is not measured yet.
MCOL_POINTS = 1 << 15


def _e_sum_fn(spec: XCSpec):
    """total(sv, n, gn[, tn]): the energy density summed over a batch of
    points; sv (4, N) = [s, gs_x, gs_y, gs_z] (5 rows with tau_s for a
    meta-GGA, with tn (N,) the total kinetic-energy density), n (N,), gn
    (3, N)."""
    efn = exc_density_fn(spec)

    def total(sv, n, gn, tn=None):
        s, gs = sv[0], sv[1:4]
        taus = () if tn is None else (0.5 * (tn + sv[4]), 0.5 * (tn - sv[4]))
        return torch.sum(efn(0.5 * (n + s), 0.5 * (n - s), 0.5 * (gn + gs), 0.5 * (gn - gs),
                             *taus))

    return total


def sf_kernel_mcol(spec: XCSpec, weights, rho0, nt: int = 20):
    """Weight-included multicollinear SF kernel matrix over the (value,
    grad_x, grad_y, grad_z[, tau]) components of the transition density:
    (ng, 4, 4), or (ng, 5, 5) for a meta-GGA spec, whose rho0 is the
    6-tuple (JAX `xc/mcol.py:73`)."""
    mgga = spec.needs_tau
    ra, rb, ga, gb, *taus = rho0
    dt, dev = ra.dtype, ra.device
    mask = (ra > MASK_RHO) | (rb > MASK_RHO)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    w = torch.where(mask, weights, zero)
    n_s = torch.where(mask, ra + rb, one)
    m_s = torch.where(mask, ra - rb, zero)
    gn_s = torch.where(mask[None, :], ga + gb, zero)
    gm_s = torch.where(mask[None, :], ga - gb, zero)
    if mgga:
        # a benign tau on masked points: positive, and with g = 0 (z = 0)
        tn_s = torch.where(mask, taus[0] + taus[1], one)
        tm_s = torch.where(mask, taus[0] - taus[1], zero)

    grad_sv = torch.func.grad(_e_sum_fn(spec), argnums=0)

    # Integrate (1/2) int_{-1}^{1} H(t) dt = int_0^1 H(t) dt (even integrand)
    # with the substitution t = 1 - (1-u)^3: at full spin polarization the
    # integrand diverges like (1-t)^{-2/3} (LDA-exchange f_ss at rho_b -> 0)
    # and the cubic substitution maps it to a bounded integrand, so
    # Gauss-Legendre in u converges fast.
    u, wu = np.polynomial.legendre.leggauss(nt)
    u = 0.5 * (u + 1.0)
    x = torch.as_tensor(1.0 - (1.0 - u) ** 3, dtype=dt, device=dev)
    wt = torch.as_tensor(0.5 * wu * 3.0 * (1.0 - u) ** 2, dtype=dt, device=dev)

    sv0 = torch.cat([m_s[None, :], gm_s] + ([tm_s[None, :]] if mgga else []), dim=0)
    nk, ng = sv0.shape  # (4 or 5, ng)
    # chunks joined, not written into a preallocated tensor: the gradient's
    # Lagrangian (`grad/xcgrid.py`) evaluates this kernel under torch.func
    H = []
    for g0 in range(0, ng, MCOL_POINTS):
        g = slice(g0, g0 + MCOL_POINTS)
        npts = sv0[:, g].shape[1]
        # the batch: every t sample of every point of the chunk, t-major
        sv = (x[None, :, None] * sv0[:, None, g]).reshape(nk, -1)
        rest = (n_s[g].repeat(nt), gn_s[:, g].repeat(1, nt))
        if mgga:
            rest = rest + (tn_s[g].repeat(nt),)
        # the unit directions as one batch of tangents: the primal pass runs
        # once, not once per column
        tangents = torch.eye(nk, dtype=dt, device=dev)[:, :, None].expand(nk, nk, sv.shape[1])
        cols = torch.func.vmap(
            lambda t: torch.func.jvp(lambda s: grad_sv(s, *rest), (sv,), (t,))[1])(tangents)
        H.append(torch.einsum("t,batg->gab", wt, cols.reshape(nk, nk, nt, npts)))
    # SF-TDA kernel = f_xx + f_yy = 2 * transverse second derivative; this
    # is what makes the LDA limit equal (vxc_a-vxc_b)/(rho_a-rho_b).
    return 2.0 * torch.cat(H) * w[:, None, None]


def sf_mcol_tensor(fxcH_w, ao, orb_o, orb_v) -> torch.Tensor:
    """(ia|f_mc|jb) coupling tensor (no, nv, no, nv) for the dense SF
    builders (JAX `xc/mcol.py:139`): fxcH_w (ng, 4, 4) weight-included, or
    (ng, 5, 5) with the tau row and column of a meta-GGA, ao (4, ng, nao),
    orb_o/orb_v tensors on ao's device.  Over chunks of points: R (4 or 5,
    gc, nov), G_d = sum_c R_c fxcH_cd, then out += sum_d G_d^T R_d, one
    matrix product of K = 4 (5) gc."""
    no, nv = orb_o.shape[1], orb_v.shape[1]
    tau = fxcH_w.shape[-1] == 5
    out = torch.zeros((no * nv, no * nv), dtype=ao.dtype, device=ao.device)
    for g0 in range(0, ao.shape[1], DENSE_CHUNK):
        g = slice(g0, g0 + DENSE_CHUNK)
        R = mo_pair_features(ao[:, g], orb_o, orb_v, tau=tau)
        G = torch.einsum("cgp,gcd->dgp", R, fxcH_w[g])
        out.addmm_(G.reshape(-1, no * nv).T, R.reshape(-1, no * nv))
    return out.reshape(no, nv, no, nv)


def sf_v1mat_mcol(ao, fxcH_w, dm1s) -> torch.Tensor:
    """Matrix-free SF response with the multicollinear kernel (JAX
    `xc/mcol.py:160`): dm1s (nset, nao, nao) alpha->beta transition
    matrices (non-hermitian); returns (nset, nao, nao).  rho1's four rows
    (five with a meta-GGA's tau) from K2 on the symmetrized stack, the
    per-point kernel, then K3 on the AO table gives v + vg + vg^T (+ the
    tau term), the symmetrized gradient part of the JAX code; both kernels
    in their atomic order (as `xc/interface.fxc_v1mat`)."""
    tau = fxcH_w.shape[-1] == 5
    r, g, *t = cache_rho(ao, dm1s, hermi=False, fixed_order=False, tau=tau)
    rho1 = torch.cat([r[:, None], g] + ([t[0][:, None]] if tau else []), dim=1)
    wv = torch.einsum("gab,xbg->xag", fxcH_w, rho1)
    out = torch.zeros_like(dm1s)
    grid_back(wv[:, 0].contiguous(), wv[:, 1:4].contiguous(), ao, 0, 0, out,
              dwt=wv[:, 4].contiguous() if tau else None)
    return out

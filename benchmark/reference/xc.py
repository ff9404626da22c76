"""Plain exchange-correlation functionals and their response kernels.

The energy densities e(ra, rb, gaa, gab, gbb) of the functionals the cells
use (Slater, B88 and its gradient correction, VWN3 (RPA), LYP), with the
constants and guards of the published forms as libxc and PySCF use them;
the derivatives come from ``torch.autograd`` alone (no ``torch.func``):

- ``hessian``: the per-point Hessian of sum_g w e with respect to (ra, rb,
  grad ra, grad rb), eight variables a point, from eight double-backward
  passes, so that the response to any transition density is one product;
- ``sf_alda0``: the ALDA0 spin-flip kernel w (va - vb) / (ra - rb + 1e-9),
  the potentials in the LDA limit (gradients zero).
"""

from __future__ import annotations

import math

import torch

TINY_RHO = 1e-15   # density clamp inside every functional
MASK_RHO = 1e-11   # points where both spin densities fall below it are dropped

_CX = (3.0 / 4.0) * (6.0 / math.pi) ** (1.0 / 3.0)
_B88_BETA = 0.0042
_LYP_A, _LYP_B, _LYP_C, _LYP_D = 0.04918, 0.132, 0.2533, 0.349
_CF = 0.3 * (3.0 * math.pi ** 2) ** (2.0 / 3.0)
# VWN (RPA parametrisation): paramagnetic, ferromagnetic, spin stiffness
_VWN3 = {"P": (0.0310907, 13.0720, 42.7198, -0.409286),
         "F": (0.01554535, 20.1231, 101.578, -0.743294),
         "A": (-1.0 / (6.0 * math.pi ** 2), 1.06835, 11.4813, -0.228344)}
_FZ_DEN = 2.0 * (2.0 ** (1.0 / 3.0) - 1.0)
_FPP0 = 4.0 / (9.0 * (2.0 ** (1.0 / 3.0) - 1.0))


def _safe(r):
    return torch.clamp_min(r, TINY_RHO)


def slater(ra, rb, gaa, gab, gbb):
    return -_CX * (_safe(ra) ** (4.0 / 3.0) + _safe(rb) ** (4.0 / 3.0))


def _b88_spin(r, g):
    r43 = _safe(r) ** (4.0 / 3.0)
    x = torch.sqrt(torch.clamp_min(g, 0.0) + 1e-35) / r43
    return -_CX * r43 - _B88_BETA * r43 * x * x / (1.0 + 6.0 * _B88_BETA * x * torch.asinh(x))


def b88(ra, rb, gaa, gab, gbb):
    return _b88_spin(ra, gaa) + _b88_spin(rb, gbb)


def b88_gc(ra, rb, gaa, gab, gbb):
    return b88(ra, rb, gaa, gab, gbb) - slater(ra, rb, gaa, gab, gbb)


def _vwn_f(x, A, b, c, x0):
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = math.sqrt(4.0 * c - b * b)
    atn = torch.atan(Q / (2.0 * x + b))
    return A * (torch.log(x * x / X) + 2.0 * b / Q * atn
                - b * x0 / X0 * (torch.log((x - x0) ** 2 / X) + 2.0 * (b + 2.0 * x0) / Q * atn))


def vwn3(ra, rb, gaa, gab, gbb):
    ra, rb = _safe(ra), _safe(rb)
    rho = ra + rb
    zeta = (ra - rb) / rho
    m = 8.0 * torch.finfo(zeta.dtype).eps
    zeta = torch.clamp(zeta, -1.0 + m, 1.0 - m)
    x = torch.sqrt((3.0 / (4.0 * math.pi * rho)) ** (1.0 / 3.0))
    eP, eF, eA = (_vwn_f(x, *_VWN3[k]) for k in "PFA")
    f = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / _FZ_DEN
    z4 = zeta ** 4
    return rho * (eP + eA * f / _FPP0 * (1.0 - z4) + (eF - eP) * f * z4)


def lyp(ra, rb, gaa, gab, gbb):
    ra, rb = _safe(ra), _safe(rb)
    rho = ra + rb
    gtot = gaa + gbb + 2.0 * gab
    rm13 = rho ** (-1.0 / 3.0)
    denom = 1.0 + _LYP_D * rm13
    omega = torch.exp(-_LYP_C * rm13) / denom * rho ** (-11.0 / 3.0)
    delta = _LYP_C * rm13 + _LYP_D * rm13 / denom
    inner = (2.0 ** (11.0 / 3.0) * _CF * (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
             + (47.0 / 18.0 - 7.0 * delta / 18.0) * gtot
             - (5.0 / 2.0 - delta / 18.0) * (gaa + gbb)
             - (delta - 11.0) / 9.0 * (ra / rho * gaa + rb / rho * gbb))
    t2 = (ra * rb * inner - (2.0 / 3.0) * rho ** 2 * gtot
          + ((2.0 / 3.0) * rho ** 2 - ra ** 2) * gbb + ((2.0 / 3.0) * rho ** 2 - rb ** 2) * gaa)
    return -4.0 * _LYP_A / denom * ra * rb / rho - _LYP_A * _LYP_B * omega * t2


# name -> (the share of exact exchange, [(weight, energy density)])
FUNCTIONALS = {
    "bhandhlyp": (0.5, [(0.5, b88), (1.0, lyp)]),
    "b3lyp": (0.2, [(0.80, slater), (0.72, b88_gc), (0.19, vwn3), (0.81, lyp)]),
}


def hyb(name: str) -> float:
    return FUNCTIONALS[name][0]


def energy_density(name: str, ra, rb, ga, gb):
    """e(g) of the functional ``name`` from the spin densities and their
    gradients ga, gb (3, ng)."""
    gaa, gab, gbb = (ga * ga).sum(0), (ga * gb).sum(0), (gb * gb).sum(0)
    return sum(w * f(ra, rb, gaa, gab, gbb) for w, f in FUNCTIONALS[name][1])


def sanitize(w, rho):
    """(w, rho, mask): points where both densities fall below MASK_RHO get
    weight 0 and the benign density (1, 1, 0, 0), so that no derivative
    sees a pathological input."""
    ra, rb, ga, gb = rho
    mask = (ra > MASK_RHO) | (rb > MASK_RHO)
    one, zero = torch.ones_like(ra), torch.zeros_like(ra)
    return (torch.where(mask, w, zero),
            (torch.where(mask, ra, one), torch.where(mask, rb, one),
             torch.where(mask, ga, zero), torch.where(mask, gb, zero)), mask)


def hessian(name: str, w, rho) -> torch.Tensor:
    """(8, 8, ng): d^2 (sum_g w e) / dx_i dx_j per point, x = (ra, rb, ga_x,
    ga_y, ga_z, gb_x, gb_y, gb_z), on sanitized inputs."""
    ra, rb, ga, gb = rho
    x = torch.cat([ra[None], rb[None], ga, gb]).detach().requires_grad_(True)
    E = torch.sum(w * energy_density(name, x[0], x[1], x[2:5], x[5:8]))
    (v,) = torch.autograd.grad(E, x, create_graph=True)
    rows = [torch.autograd.grad(v[i].sum(), x, retain_graph=i < 7)[0] for i in range(8)]
    return torch.stack(rows).detach()


def sf_alda0(name: str, w, rho_raw, rho_s) -> torch.Tensor:
    """(ng,) the weighted ALDA0 spin-flip kernel: the potentials of the
    sanitized densities with the gradients zeroed, over the raw density
    difference."""
    ra, rb = (r.detach().requires_grad_(True) for r in rho_s[:2])
    zg = torch.zeros_like(rho_s[2])
    E = torch.sum(w * energy_density(name, ra, rb, zg, zg))
    va, vb = torch.autograd.grad(E, (ra, rb))
    return (va - vb) / (rho_raw[0] - rho_raw[1] + 1e-9)

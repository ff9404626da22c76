"""Exchange-correlation energy densities in torch (LDA, GGA and meta-GGA).

Every functional is an energy density ``e(rho_a, rho_b, gamma_aa, gamma_ab,
gamma_bb)`` (energy per volume), a meta-GGA one with the two spin
kinetic-energy densities ``(tau_a, tau_b)`` as two more arguments; first and
second derivatives come from
``torch.func`` in `xc/interface.py`.  Same formulas, constants and guards as
the JAX package's `xc/functionals.py`: the density clamp `_safe_rho`, the
tiny-gradient guard ``+1e-35`` of B88 and the dtype-aware `_clip_zeta` keep
first and second derivatives finite in f64 and f32.

Implemented: Slater exchange, VWN5 and VWN3(RPA) correlation, PW92
correlation, B88 exchange (and its ITYH short-range form), LYP correlation,
PBE exchange/correlation, TPSS exchange and correlation (meta-GGA).
"""

from __future__ import annotations

import math

import torch

TINY_RHO = 1e-15


def _safe_rho(rho):
    return torch.clamp_min(rho, TINY_RHO)


# ---------------------------------------------------------------- exchange

_CX = (3.0 / 4.0) * (6.0 / math.pi) ** (1.0 / 3.0)


def slater_x(ra, rb, gaa, gab, gbb):
    ra = _safe_rho(ra)
    rb = _safe_rho(rb)
    return -_CX * (ra ** (4.0 / 3.0) + rb ** (4.0 / 3.0))


_B88_BETA = 0.0042


def _b88_spin(r, g):
    r = _safe_rho(r)
    r43 = r ** (4.0 / 3.0)
    # 1e-35 keeps d/dg sqrt(g) finite at g=0 in f32 as in f64
    x = torch.sqrt(torch.clamp_min(g, 0.0) + 1e-35) / r43
    denom = 1.0 + 6.0 * _B88_BETA * x * torch.asinh(x)
    return -_CX * r43 - _B88_BETA * r43 * x * x / denom


def b88_x(ra, rb, gaa, gab, gbb):
    """B88 exchange including the LDA part."""
    return _b88_spin(ra, gaa) + _b88_spin(rb, gbb)


def b88_x_gradient_correction(ra, rb, gaa, gab, gbb):
    """Only the gradient-correction part of B88 (for B3LYP mixing)."""
    return b88_x(ra, rb, gaa, gab, gbb) - slater_x(ra, rb, gaa, gab, gbb)


def _sr_factor(a):
    """Short-range attenuation factor of the LDA-form exchange hole,
    a = omega / (2 k_eff) (Gill/Adamson form); F(0)=1, F -> 0 as a -> inf."""
    a = torch.clamp_min(a, 1e-10)
    inv2a = 1.0 / (2.0 * a)
    expo = torch.exp(-torch.clamp_max(inv2a * inv2a, 500.0))
    bracket = (
        math.sqrt(math.pi) * torch.special.erf(inv2a)
        - 3.0 * a
        + 4.0 * a**3
        + (2.0 * a - 4.0 * a**3) * expo
    )
    return torch.clamp(1.0 - (8.0 / 3.0) * a * bracket, 0.0, 1.0)


def _b88_sr_spin(r, g, omega):
    """ITYH short-range B88 at the effective Fermi momentum
    k_eff = -(4 pi / 3) eps_x^GGA."""
    r = _safe_rho(r)
    e = _b88_spin(r, g)
    k_eff = -(4.0 * math.pi / 3.0) * (e / r)
    a = omega / (2.0 * torch.clamp_min(k_eff, 1e-12))
    return e * _sr_factor(a)


def make_b88_sr(omega: float):
    """Short-range (erf-complement) B88 exchange at fixed omega."""

    def b88_sr(ra, rb, gaa, gab, gbb):
        return _b88_sr_spin(ra, gaa, omega) + _b88_sr_spin(rb, gbb, omega)

    return b88_sr


_PBE_KAPPA = 0.8040
_PBE_MU = 0.2195149727645171


def _pbe_x_spin(r, g):
    r = _safe_rho(r)
    # spin scaling: e_x(r, g) = 0.5 * e_x_unpolarized(2r, 4g)
    rho = 2.0 * r
    grho2 = 4.0 * torch.clamp_min(g, 0.0)
    kf = (3.0 * math.pi**2 * rho) ** (1.0 / 3.0)
    ex_unif = -(3.0 / (4.0 * math.pi)) * kf * rho
    s2 = grho2 / (4.0 * kf**2 * rho**2)
    F = 1.0 + _PBE_KAPPA - _PBE_KAPPA / (1.0 + _PBE_MU * s2 / _PBE_KAPPA)
    return 0.5 * ex_unif * F


def pbe_x(ra, rb, gaa, gab, gbb):
    return _pbe_x_spin(ra, gaa) + _pbe_x_spin(rb, gbb)


# ------------------------------------------------------------- correlation

def _vwn_F(x, A, b, c, x0):
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = math.sqrt(4.0 * c - b * b)
    atn = torch.atan(Q / (2.0 * x + b))
    return A * (
        torch.log(x * x / X)
        + 2.0 * b / Q * atn
        - b * x0 / X0 * (torch.log((x - x0) ** 2 / X) + 2.0 * (b + 2.0 * x0) / Q * atn)
    )


_VWN5 = {
    "P": (0.0310907, 3.72744, 12.9352, -0.10498),
    "F": (0.01554535, 7.06042, 18.0578, -0.32500),
    "A": (-1.0 / (6.0 * math.pi**2), 1.13107, 13.0045, -0.00475840),
}
_VWN3 = {
    "P": (0.0310907, 13.0720, 42.7198, -0.409286),
    "F": (0.01554535, 20.1231, 101.578, -0.743294),
    "A": (-1.0 / (6.0 * math.pi**2), 1.06835, 11.4813, -0.228344),
}

_FZ_DEN = 2.0 * (2.0 ** (1.0 / 3.0) - 1.0)
_FPP0 = 4.0 / (9.0 * (2.0 ** (1.0 / 3.0) - 1.0))


def _spin_f(zeta):
    return ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / _FZ_DEN


def _vwn_eps(rho, zeta, params):
    rs = (3.0 / (4.0 * math.pi * rho)) ** (1.0 / 3.0)
    x = torch.sqrt(rs)
    eP = _vwn_F(x, *params["P"])
    eF = _vwn_F(x, *params["F"])
    eA = _vwn_F(x, *params["A"])
    f = _spin_f(zeta)
    z4 = zeta**4
    return eP + eA * f / _FPP0 * (1.0 - z4) + (eF - eP) * f * z4


def _clip_zeta(ra, rb):
    """Spin polarization clipped inside (-1, 1) by a dtype-aware margin:
    a fixed 1e-15 is below f32 epsilon, so zeta would round back to +/-1
    and the (1 -/+ zeta)^(-4/3) terms of the derivatives divide by zero.
    8*eps keeps ~3 ulps of clearance in either dtype."""
    rho = ra + rb
    zeta = (ra - rb) / rho
    m = 8.0 * torch.finfo(zeta.dtype).eps
    return torch.clamp(zeta, -1.0 + m, 1.0 - m)


def vwn5_c(ra, rb, gaa, gab, gbb):
    ra = _safe_rho(ra)
    rb = _safe_rho(rb)
    rho = ra + rb
    zeta = _clip_zeta(ra, rb)
    return rho * _vwn_eps(rho, zeta, _VWN5)


def vwn3_c(ra, rb, gaa, gab, gbb):
    ra = _safe_rho(ra)
    rb = _safe_rho(rb)
    rho = ra + rb
    zeta = _clip_zeta(ra, rb)
    return rho * _vwn_eps(rho, zeta, _VWN3)


def _pw92_G(rs, A, a1, b1, b2, b3, b4):
    srs = torch.sqrt(rs)
    den = 2.0 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    return -2.0 * A * (1.0 + a1 * rs) * torch.log(1.0 + 1.0 / den)


def _pw92_eps(rho, zeta):
    rs = (3.0 / (4.0 * math.pi * rho)) ** (1.0 / 3.0)
    e0 = _pw92_G(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
    e1 = _pw92_G(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
    mac = _pw92_G(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
    f = _spin_f(zeta)
    z4 = zeta**4
    return e0 - mac * f / _FPP0 * (1.0 - z4) + (e1 - e0) * f * z4


def pw92_c(ra, rb, gaa, gab, gbb):
    ra = _safe_rho(ra)
    rb = _safe_rho(rb)
    rho = ra + rb
    zeta = _clip_zeta(ra, rb)
    return rho * _pw92_eps(rho, zeta)


_LYP_A = 0.04918
_LYP_B = 0.132
_LYP_C = 0.2533
_LYP_D = 0.349
_CF = 0.3 * (3.0 * math.pi**2) ** (2.0 / 3.0)


def lyp_c(ra, rb, gaa, gab, gbb):
    ra = _safe_rho(ra)
    rb = _safe_rho(rb)
    rho = ra + rb
    gtot = gaa + gbb + 2.0 * gab
    rm13 = rho ** (-1.0 / 3.0)
    denom = 1.0 + _LYP_D * rm13
    omega = torch.exp(-_LYP_C * rm13) / denom * rho ** (-11.0 / 3.0)
    delta = _LYP_C * rm13 + _LYP_D * rm13 / denom
    t1 = -4.0 * _LYP_A / denom * ra * rb / rho
    inner = (
        2.0 ** (11.0 / 3.0) * _CF * (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
        + (47.0 / 18.0 - 7.0 * delta / 18.0) * gtot
        - (5.0 / 2.0 - delta / 18.0) * (gaa + gbb)
        - (delta - 11.0) / 9.0 * (ra / rho * gaa + rb / rho * gbb)
    )
    t2 = (
        ra * rb * inner
        - (2.0 / 3.0) * rho**2 * gtot
        + ((2.0 / 3.0) * rho**2 - ra**2) * gbb
        + ((2.0 / 3.0) * rho**2 - rb**2) * gaa
    )
    return t1 - _LYP_A * _LYP_B * omega * t2


_PBE_GAMMA = (1.0 - math.log(2.0)) / math.pi**2
_PBE_BETA = 0.06672455060314922


def pbe_c(ra, rb, gaa, gab, gbb):
    ra = _safe_rho(ra)
    rb = _safe_rho(rb)
    rho = ra + rb
    zeta = _clip_zeta(ra, rb)
    eps = _pw92_eps(rho, zeta)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    kf = (3.0 * math.pi**2 * rho) ** (1.0 / 3.0)
    ks = torch.sqrt(4.0 * kf / math.pi)
    gtot = torch.clamp_min(gaa + gbb + 2.0 * gab, 0.0)
    t2 = gtot / (2.0 * phi * ks * rho) ** 2
    expo = torch.exp(-eps / (_PBE_GAMMA * phi**3))
    A = _PBE_BETA / _PBE_GAMMA / torch.clamp_min(expo - 1.0, 1e-30)
    num = 1.0 + A * t2
    den = 1.0 + A * t2 + A * A * t2 * t2
    H = (
        _PBE_GAMMA
        * phi**3
        * torch.log(1.0 + _PBE_BETA / _PBE_GAMMA * t2 * num / den)
    )
    return rho * (eps + H)


# ---------------------------------------------------------------- meta-GGA
#
# MGGA energy densities take two extra arguments (ta, tb): the spin
# kinetic-energy densities tau_sigma = 1/2 sum_i |grad phi_i_sigma|^2.
# TPSS: Tao, Perdew, Staroverov, Scuseria, PRL 91, 146401 (2003); the
# x(p, z) expression and constants follow eqs. (5)-(12) and the revPKZB
# correlation eqs. (11)-(14) of the companion JCP 120, 6898 (2004).

def _max(x, c):
    """max(x, c) with the JAX package's derivative at a tie (half to each
    side; ``torch.clamp_min`` passes it all to x).  In TPSS the ties are
    real: |grad zeta|^2 is exactly 0 wherever ra == rb, and its Hessian
    takes that factor."""
    c = c if isinstance(c, torch.Tensor) else torch.as_tensor(c, dtype=x.dtype, device=x.device)
    return torch.maximum(x, c)


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi), with its derivative at the ends."""
    return torch.minimum(_max(x, lo), torch.as_tensor(hi, dtype=x.dtype, device=x.device))


_TPSS_KAPPA = 0.804
_TPSS_C = 1.59096
_TPSS_E = 1.537
_TPSS_B = 0.40
_TPSS_MU = 0.21951
_TPSS_D = 2.8


def _tpss_fx(rho, gamma, tau):
    """TPSS exchange enhancement factor for one spin-unpolarized density."""
    rho = _safe_rho(rho)
    gamma = _max(gamma, 0.0)
    kf2 = (3.0 * math.pi**2 * rho) ** (2.0 / 3.0)
    p = gamma / (4.0 * kf2 * rho**2)
    tau_w = gamma / (8.0 * rho)
    tau_u = 0.3 * kf2 * rho
    tau = _max(tau, tau_w + 1e-30)  # z <= 1, alpha >= 0 by physics
    z = tau_w / tau
    alpha = (tau - tau_w) / _max(tau_u, 1e-30)
    qb = 0.45 * (alpha - 1.0) / torch.sqrt(
        1.0 + _TPSS_B * alpha * (alpha - 1.0)
    ) + 2.0 * p / 3.0
    z2 = z * z
    t1 = (10.0 / 81.0 + _TPSS_C * z2 / (1.0 + z2) ** 2) * p
    t2 = (146.0 / 2025.0) * qb * qb
    # the dtype's smallest normal number keeps the sqrt's derivative finite
    # at p = z = 0 (uniform gas, sanitized points): a fixed 1e-60 underflows
    # to 0 in f32 and the 0/0 returns
    t3 = -(73.0 / 405.0) * qb * torch.sqrt(
        0.5 * (0.6 * z) ** 2 + 0.5 * p * p + torch.finfo(p.dtype).tiny
    )
    t4 = (1.0 / _TPSS_KAPPA) * (10.0 / 81.0) ** 2 * p * p
    t5 = 2.0 * math.sqrt(_TPSS_E) * (10.0 / 81.0) * (0.6 * z) ** 2
    t6 = _TPSS_E * _TPSS_MU * p**3
    x = (t1 + t2 + t3 + t4 + t5 + t6) / (1.0 + math.sqrt(_TPSS_E) * p) ** 2
    return 1.0 + _TPSS_KAPPA - _TPSS_KAPPA / (1.0 + x / _TPSS_KAPPA)


def _lda_x_density(rho):
    """Spin-unpolarized LDA exchange energy density (per volume)."""
    return -(3.0 / 4.0) * (3.0 / math.pi) ** (1.0 / 3.0) * rho ** (4.0 / 3.0)


def tpss_x(ra, rb, gaa, gab, gbb, ta, tb):
    """TPSS exchange via the exact spin scaling
    E_x[ra, rb] = (E_x[2 ra] + E_x[2 rb]) / 2."""
    out = 0.0
    for r, g, t in ((ra, gaa, ta), (rb, gbb, tb)):
        r2, g2, t2 = 2.0 * r, 4.0 * g, 2.0 * t
        out = out + 0.5 * _lda_x_density(_safe_rho(r2)) * _tpss_fx(r2, g2, t2)
    return out


def _pbe_eps(ra, rb, gaa, gab, gbb):
    """PBE correlation energy per particle."""
    return pbe_c(ra, rb, gaa, gab, gbb) / _safe_rho(ra + rb)


def tpss_c(ra, rb, gaa, gab, gbb, ta, tb):
    """TPSS (revPKZB-based) correlation energy density."""
    ra = _safe_rho(ra)
    rb = _safe_rho(rb)
    rho = ra + rb
    tau = _max(ta + tb, 1e-30)
    gtot = _max(gaa + 2.0 * gab + gbb, 0.0)
    tau_w = gtot / (8.0 * rho)
    z = _clip(tau_w / _max(tau, tau_w + 1e-30), 0.0, 1.0)
    zeta = _clip_zeta(ra, rb)
    # xi = |grad zeta| / (2 (3 pi^2 rho)^(1/3)), |grad zeta|^2 through the
    # spin gammas (grad zeta = (rb ga - ra gb) 2 / rho^2) in spin-fraction
    # form (sa = rb/rho, sb = ra/rho): the plain quotient by rho^4 has a
    # derivative through rho^8, which underflows in f32 below rho ~ 1e-5
    inv_rho = 1.0 / rho
    sa = rb * inv_rho
    sb = ra * inv_rho
    gznum = _max(sa * sa * gaa - 2.0 * sa * sb * gab + sb * sb * gbb, 0.0)
    xi2 = (gznum * inv_rho * inv_rho * inv_rho ** (2.0 / 3.0)
           / (3.0 * math.pi**2) ** (2.0 / 3.0))
    up = _max(1.0 + zeta, 1e-12)
    dn = _max(1.0 - zeta, 1e-12)
    Cnum = 0.53 + 0.87 * zeta**2 + 0.50 * zeta**4 + 2.26 * zeta**6
    Cden = (1.0 + 0.5 * xi2 * (up ** (-4.0 / 3.0) + dn ** (-4.0 / 3.0))) ** 4
    C = Cnum / Cden
    eps = _pbe_eps(ra, rb, gaa, gab, gbb)
    # per-spin fully polarized PBE epsilons, bounded below by eps
    tiny = torch.full_like(ra, 1e-15)
    zg = torch.zeros_like(gaa)
    eps_a = _max(_pbe_eps(ra, tiny, gaa, zg, zg), eps)
    eps_b = _max(_pbe_eps(rb, tiny, gbb, zg, zg), eps)
    z2 = z * z
    eps_rev = eps * (1.0 + C * z2) - (1.0 + C) * z2 * (
        (ra / rho) * eps_a + (rb / rho) * eps_b
    )
    return rho * eps_rev * (1.0 + _TPSS_D * eps_rev * z2 * z)


MGGA_NAMES = frozenset({"tpss_x", "tpss_c"})


FUNCTIONALS = {
    "slater": slater_x,
    "b88": b88_x,
    "b88_gc": b88_x_gradient_correction,
    "pbe_x": pbe_x,
    "vwn5": vwn5_c,
    "vwn3": vwn3_c,
    "vwn_rpa": vwn3_c,
    "pw92": pw92_c,
    "lyp": lyp_c,
    "pbe_c": pbe_c,
    # fixed-omega short-range exchange component for RSH composites
    "b88_sr@0.33": make_b88_sr(0.33),
    # meta-GGA (the signature carries the two tau arguments)
    "tpss_x": tpss_x,
    "tpss_c": tpss_c,
}

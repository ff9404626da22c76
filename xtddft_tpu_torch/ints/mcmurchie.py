"""McMurchie–Davidson Gaussian integral engine (host-side numpy).

Replaces the libcint C library that backs every integral in the reference
(`pyscf.gto.intor*` / `ao2mo.general`, see SURVEY.md §2.4).  Contracted
shell-pair Hermite expansions are vectorized over primitive pairs; the
Boys function uses the regularized incomplete gamma with stable downward
recursion.

Key objects
-----------
- ``boys(mmax, x)``              F_m(x) for m = 0..mmax, vectorized in x
- ``e_coeffs_1d``                Hermite expansion E^{ij}_t per dimension
- ``ShellPair``                  precomputed Hermite expansion of a contracted
                                 shell pair: H[cart_ab, herm, primpair]
- ``hermite_coulomb``            R_{tuv} tensor via recursion
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
from scipy.special import gammainc, gammaln

from xtddft_tpu_torch.ints.shell import Shell, cart_components, ncart

__all__ = [
    "boys",
    "herm_indices",
    "ShellPair",
    "make_shell_pair",
    "hermite_coulomb",
]


def boys(mmax: int, x: np.ndarray) -> np.ndarray:
    """Boys function F_m(x), shape (mmax+1,) + x.shape."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty((mmax + 1,) + x.shape, dtype=np.float64)
    small = x < 1e-13
    xs = np.where(small, 1.0, x)  # avoid 0^negative
    a = mmax + 0.5
    # F_M(x) = Gamma(a) * P(a, x) / (2 x^a)
    fm = np.exp(gammaln(a)) * gammainc(a, xs) / (2.0 * xs**a)
    fm = np.where(small, 1.0 / (2 * mmax + 1) - x / (2 * mmax + 3), fm)
    out[mmax] = fm
    if mmax > 0:
        ex = np.exp(-x)
        for m in range(mmax, 0, -1):
            fm = (2.0 * x * fm + ex) / (2 * m - 1)
            fm = np.where(small, 1.0 / (2 * m - 1) - x / (2 * m + 1), fm)
            out[m - 1] = fm
    return out


@lru_cache(maxsize=None)
def herm_indices(L: int) -> tuple[tuple[int, int, int], ...]:
    """All Hermite (t,u,v) with t+u+v <= L, ordered by total degree."""
    idx = []
    for deg in range(L + 1):
        for t in range(deg, -1, -1):
            for u in range(deg - t, -1, -1):
                idx.append((t, u, deg - t - u))
    return tuple(idx)


@lru_cache(maxsize=None)
def herm_index_map(L: int) -> dict:
    return {tuv: i for i, tuv in enumerate(herm_indices(L))}


def e_coeffs_1d(la: int, lb: int, a: np.ndarray, b: np.ndarray, AB: np.ndarray):
    """E^{ij}_t along one dimension for all primitive pairs.

    Parameters are flat arrays over primitive pairs; returns array of shape
    (la+1, lb+1, la+lb+1, npair).  The t=0, i=j=0 element carries the
    Gaussian product prefactor exp(-mu AB^2).
    """
    p = a + b
    mu = a * b / p
    # P - A = b/p * (B - A) = -b/p * AB  with AB = A - B
    XPA = -b / p * AB
    XPB = a / p * AB
    npair = p.shape[0]
    E = np.zeros((la + 1, lb + 1, la + lb + 1, npair))
    E[0, 0, 0] = np.exp(-mu * AB * AB)
    inv2p = 0.5 / p
    for i in range(1, la + 1):
        for t in range(i + 1):
            val = XPA * E[i - 1, 0, t]
            if t > 0:
                val = val + inv2p * E[i - 1, 0, t - 1]
            if t + 1 <= i - 1:
                val = val + (t + 1) * E[i - 1, 0, t + 1]
            E[i, 0, t] = val
    for j in range(1, lb + 1):
        for i in range(la + 1):
            for t in range(i + j + 1):
                val = XPB * E[i, j - 1, t]
                if t > 0:
                    val = val + inv2p * E[i, j - 1, t - 1]
                if t + 1 <= i + j - 1:
                    val = val + (t + 1) * E[i, j - 1, t + 1]
                E[i, j, t] = val
    return E


@dataclasses.dataclass
class ShellPair:
    """Contracted Hermite representation of a shell pair.

    H has shape (ncart_a * ncart_b, nherm, npair): the coefficient of each
    Hermite Gaussian Λ_tuv(r; p, P) in the expansion of each Cartesian
    component product, including both contraction coefficients.
    """

    la: int
    lb: int
    H: np.ndarray  # (ncart_ab, nherm, npair)
    p: np.ndarray  # (npair,) combined exponents
    P: np.ndarray  # (npair, 3) Gaussian product centers
    cc: np.ndarray  # (npair,) product of contraction coefficients
    A: np.ndarray  # (3,) center of shell a
    B: np.ndarray  # (3,) center of shell b

    @property
    def L(self) -> int:
        return self.la + self.lb

    @property
    def npair(self) -> int:
        return self.p.shape[0]


def make_shell_pair(sha: Shell, shb: Shell, ldelta: int = 0) -> ShellPair:
    """Build the Hermite expansion for a contracted shell pair.

    ``ldelta`` raises the expansion order (needed for moment/derivative
    integrals that shift angular momentum up by 1 or 2).
    """
    la, lb = sha.l, shb.l
    a = np.repeat(sha.exps, len(shb.exps))
    b = np.tile(shb.exps, len(sha.exps))
    ca = np.repeat(sha.coefs, len(shb.coefs))
    cb = np.tile(shb.coefs, len(sha.coefs))
    cc = ca * cb
    AB = sha.center - shb.center
    p = a + b
    P = (a[:, None] * sha.center[None, :] + b[:, None] * shb.center[None, :]) / p[:, None]

    lae = la + ldelta
    lbe = lb + ldelta
    Ex = e_coeffs_1d(lae, lbe, a, b, AB[0])
    Ey = e_coeffs_1d(lae, lbe, a, b, AB[1])
    Ez = e_coeffs_1d(lae, lbe, a, b, AB[2])

    comps_a = cart_components(la)
    comps_b = cart_components(lb)
    L = la + lb
    hidx = herm_indices(L)
    H = np.zeros((len(comps_a) * len(comps_b), len(hidx), p.shape[0]))
    for ia_, (ix, iy, iz) in enumerate(comps_a):
        for ib_, (jx, jy, jz) in enumerate(comps_b):
            row = ia_ * len(comps_b) + ib_
            for h, (t, u, v) in enumerate(hidx):
                if t > ix + jx or u > iy + jy or v > iz + jz:
                    continue
                H[row, h] = Ex[ix, jx, t] * Ey[iy, jy, u] * Ez[iz, jz, v]
    H = H * cc[None, None, :]
    return ShellPair(la=la, lb=lb, H=H, p=p, P=P, cc=cc, A=sha.center, B=shb.center)


def make_shell_pair_deriv(sha: Shell, shb: Shell, d_bra: int | None = None,
                          d_ket: int | None = None,
                          m_bra: int | None = None) -> ShellPair:
    """Hermite expansion of (d/dr_{d_bra} chi_a) * (d/dr_{d_ket} chi_b).

    The electron-coordinate derivative of a Cartesian Gaussian is
    d/dx [(x-Ax)^i e^{-a(x-Ax)^2}] = i*(i-1 comp) - 2a*(i+1 comp), so a
    derivative pair is expanded like a normal pair with the angular
    momentum raised by one per derivative; the Hermite order is L+1 (one
    derivative) or L+2 (both).  Used for p.V.p / SO one-electron integrals
    and ip1ip2-type derivative ERIs (the reference gets these from libcint
    `int1e_pnucp` / `cint1e_prinvxp` / `int2e_ip1ip2`,
    `x2c_hamiltonian/sfX2C_soDKH1.py:218-256, 758-778`).
    """
    la, lb = sha.l, shb.l
    a = np.repeat(sha.exps, len(shb.exps))
    b = np.tile(shb.exps, len(sha.exps))
    ca = np.repeat(sha.coefs, len(shb.coefs))
    cb = np.tile(shb.coefs, len(sha.coefs))
    cc = ca * cb
    AB = sha.center - shb.center
    p = a + b
    P = (a[:, None] * sha.center[None, :] + b[:, None] * shb.center[None, :]) / p[:, None]

    if m_bra is not None and d_bra is not None:
        raise NotImplementedError("combined bra moment and bra derivative")
    nd_bra = int(d_bra is not None) + int(m_bra is not None)
    nd_ket = int(d_ket is not None)
    E = [e_coeffs_1d(la + nd_bra, lb + nd_ket, a, b, AB[dd]) for dd in range(3)]
    npair = p.shape[0]

    # per-dimension derivative-applied E tables D[dd][i, j, t] over the
    # *undifferentiated* (i, j) index ranges
    D = []
    for dd in range(3):
        tmax = la + lb + nd_bra + nd_ket + 1
        tab = np.zeros((la + 1, lb + 1, tmax, npair))
        base = E[dd]
        for i_ in range(la + 1):
            for j_ in range(lb + 1):
                if dd == d_bra and dd == d_ket:
                    v = 4.0 * a[None, :] * b[None, :] * base[i_ + 1, j_ + 1, :tmax]
                    if j_ >= 1:
                        v = v - 2.0 * a[None, :] * j_ * base[i_ + 1, j_ - 1, :tmax]
                    if i_ >= 1:
                        v = v - 2.0 * b[None, :] * i_ * base[i_ - 1, j_ + 1, :tmax]
                        if j_ >= 1:
                            v = v + i_ * j_ * base[i_ - 1, j_ - 1, :tmax]
                elif dd == d_bra:
                    v = -2.0 * a[None, :] * base[i_ + 1, j_, :tmax]
                    if i_ >= 1:
                        v = v + i_ * base[i_ - 1, j_, :tmax]
                elif dd == m_bra and dd == d_ket:
                    # (x-A_x) moment on bra combined with ket derivative
                    v = -2.0 * b[None, :] * base[i_ + 1, j_ + 1, :tmax]
                    if j_ >= 1:
                        v = v + j_ * base[i_ + 1, j_ - 1, :tmax]
                elif dd == m_bra:
                    v = base[i_ + 1, j_, :tmax]
                elif dd == d_ket:
                    v = -2.0 * b[None, :] * base[i_, j_ + 1, :tmax]
                    if j_ >= 1:
                        v = v + j_ * base[i_, j_ - 1, :tmax]
                else:
                    v = base[i_, j_, :tmax]
                tab[i_, j_] = v
        D.append(tab)

    comps_a = cart_components(la)
    comps_b = cart_components(lb)
    L = la + lb + nd_bra + nd_ket
    hidx = herm_indices(L)
    H = np.zeros((len(comps_a) * len(comps_b), len(hidx), npair))
    for ia_, ci in enumerate(comps_a):
        for ib_, cj in enumerate(comps_b):
            row = ia_ * len(comps_b) + ib_
            for h, (t, u, v) in enumerate(hidx):
                H[row, h] = (
                    D[0][ci[0], cj[0], t]
                    * D[1][ci[1], cj[1], u]
                    * D[2][ci[2], cj[2], v]
                )
    H = H * cc[None, None, :]
    return ShellPair(
        la=la + nd_bra, lb=lb + nd_ket, H=H, p=p, P=P, cc=cc,
        A=sha.center, B=shb.center,
    )


def make_pair_eijk(sha: Shell, shb: Shell, ldelta: int):
    """Raw per-dimension E tensors + pair data, for derivative/moment ints."""
    a = np.repeat(sha.exps, len(shb.exps))
    b = np.tile(shb.exps, len(sha.exps))
    ca = np.repeat(sha.coefs, len(shb.coefs))
    cb = np.tile(shb.coefs, len(sha.coefs))
    AB = sha.center - shb.center
    p = a + b
    lae = sha.l + ldelta
    lbe = shb.l + ldelta
    E = [e_coeffs_1d(lae, lbe, a, b, AB[d]) for d in range(3)]
    return E, a, b, ca * cb, p


def hermite_coulomb(L: int, p: np.ndarray, PC: np.ndarray) -> np.ndarray:
    """R^0_{tuv}(p, PC) for all t+u+v <= L.

    Returns (nherm, N) where N is the broadcast shape of p/PC rows.
    PC has shape (N, 3).
    """
    x2 = np.einsum("nd,nd->n", PC, PC)
    F = boys(L, p * x2)  # (L+1, N)
    n = PC.shape[0]
    # R[n, t, u, v] stored in dict keyed by (t,u,v) per order n
    # build with the standard downward-in-n recursion
    Rn = {m: {(0, 0, 0): ((-2.0 * p) ** m) * F[m]} for m in range(L + 1)}
    for deg in range(1, L + 1):
        for m in range(L - deg, -1, -1):
            for t in range(deg, -1, -1):
                for u in range(deg - t, -1, -1):
                    v = deg - t - u
                    key = (t, u, v)
                    if key in Rn[m]:
                        continue
                    if t > 0:
                        val = PC[:, 0] * Rn[m + 1][(t - 1, u, v)]
                        if t > 1:
                            val = val + (t - 1) * Rn[m + 1][(t - 2, u, v)]
                    elif u > 0:
                        val = PC[:, 1] * Rn[m + 1][(t, u - 1, v)]
                        if u > 1:
                            val = val + (u - 1) * Rn[m + 1][(t, u - 2, v)]
                    else:
                        val = PC[:, 2] * Rn[m + 1][(t, u, v - 1)]
                        if v > 1:
                            val = val + (v - 1) * Rn[m + 1][(t, u, v - 2)]
                    Rn[m][key] = val
    hidx = herm_indices(L)
    out = np.empty((len(hidx), n))
    for h, tuv in enumerate(hidx):
        out[h] = Rn[0][tuv]
    return out

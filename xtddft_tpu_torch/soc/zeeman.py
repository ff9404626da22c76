"""Magnetic (Zeeman) integrals in the spin-separated X2C picture.

Counterpart of the JAX package's `soc/zeeman.py`, a re-derivation of
`x2c_hamiltonian/sfX2C_zeeman.py` (JCP 141, 054111 Eqs. 181-182 for a
uniform field):

- h10[m]   orbital-Zeeman matrix (convention h10 = i B_m L_m; stored real
  antisymmetric)
- h11[s,m] spin-Zeeman matrix (h11 = B_m G_mn S_n; symmetric)

The O(alpha^2) magnetic W integrals are built from
N[d,e] = <mu| (r-G)_d V_nuc d_e |nu> via the moment+derivative shell pairs,
a class of shell pairs at a time with every nucleus at once
(`ints/soc_ints.py _nuclear_sum`), decomposing libcint's
`int1e_cg_sa10nucsp` by hand: sigma.A10 V sigma.p with A10 = (1/2) B x r
splits into the scalar part (1/2) eps_{ijm} N[j,i] and the vector part
(1/2)(delta_mc tr N - N[c,m])."""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch import units
from xtddft_tpu_torch.ints import angular_momentum, kinetic, nuclear_attraction, overlap
from xtddft_tpu_torch.ints.shell import BasisLayout
from xtddft_tpu_torch.ints.soc_ints import _EPS, _nuclear_sum
from xtddft_tpu_torch.soc import x2c as x2c_mod
from xtddft_tpu_torch.soc.somf import nuclear_deriv2


def moment_nuc_deriv(layout: BasisLayout, gauge) -> np.ndarray:
    """N[d, e, mu, nu] = <mu| (r-G)_d V_nuc d_e |nu> with
    V_nuc = -sum_A Z_A/r_A."""
    mol = layout.mol
    ops = ([(None, ("d", e)) for e in range(3)]
           + [(("m", d), ("d", e)) for d in range(3) for e in range(3)])
    N = _nuclear_sum(layout, mol.coords, -np.asarray(mol.charges, dtype=np.float64), ops,
                     moment_origin=np.asarray(gauge, dtype=np.float64))
    return N[3:].reshape(3, 3, layout.nao, layout.nao)


def magnetic_w(layout: BasisLayout, gauge):
    """(wsf[m], wsd[s, m]) magnetic W integrals (`sfX2C_zeeman.py:43-62`)."""
    N = moment_nuc_deriv(layout, gauge)
    # scalar part of sigma.A10 V sigma.p:  ints_sf[m] = 1/2 eps_{jim} N[j,i]
    ints_sf = 0.5 * np.einsum("ijm,jipq->mpq", _EPS, N)
    wsf = ints_sf - ints_sf.transpose(0, 2, 1)
    # vector part: ints_sd[m, c] = 1/2 (delta_mc tr N - N[c, m])
    trN = np.einsum("ddpq->pq", N)
    ints_sd = 0.5 * (
        np.einsum("mc,pq->mcpq", np.eye(3), trN) - N.transpose(1, 0, 2, 3)
    )
    # wsd[c, m] = -(ints_sd[m, c].T + ints_sd[m, c])
    wsd = -(ints_sd.transpose(1, 0, 3, 2) + ints_sd.transpose(1, 0, 2, 3))
    return wsf, wsd


def _get_mag(a4, sinv, x, rp, h1e, t_mat, w_mat, sgn):
    """Picture-change dressing of one magnetic operator
    (`sfX2C_zeeman.py:64-69`); already carries the full NR limit through
    the X-coupling (X -> 1: t x + x^T t - x^T t x -> t)."""
    tmp1 = rp.T @ (t_mat @ x + x.T @ t_mat + x.T @ (a4 * w_mat - t_mat) @ x) @ rp
    tmp2 = h1e @ sinv @ rp.T @ x.T @ t_mat @ x @ rp
    return tmp1 - a4 * (tmp2 + sgn * tmp2.T)


def get_zeeman(mf, gauge=None, c: float = units.C_AU):
    """(h10 (3, nao, nao), h11 (3, 3, nao, nao)) in the contracted AO basis.

    h10 antisymmetric (orbital Zeeman, i*B.L convention), h11 symmetric
    (spin Zeeman)."""
    env = mf.env
    layout = env.layout
    if gauge is None:
        gauge = env.mol.charge_center()
    unc, contr = x2c_mod.uncontract(layout)
    t = kinetic(unc)
    v = nuclear_attraction(unc)
    s = overlap(unc)
    w_sf_x2c, _ = nuclear_deriv2(unc)
    x, rp, h1e = x2c_mod.sfx2c1e(t, v, w_sf_x2c, s, c)
    sinv = np.linalg.pinv(s)
    a4 = 0.25 / c**2

    tsf = -0.5 * angular_momentum(unc, gauge_origin=gauge)
    tsd = np.zeros((3, 3, unc.nao, unc.nao))
    for i in range(3):
        tsd[i, i] = 0.5 * s
    wsf, wsd = magnetic_w(unc, gauge)

    nao = layout.nao
    h10 = np.zeros((3, nao, nao))
    h11 = np.zeros((3, 3, nao, nao))
    for m in range(3):
        full = _get_mag(a4, sinv, x, rp, h1e, tsf[m], wsf[m], -1.0)
        h10[m] = contr.T @ full @ contr
    for si in range(3):
        for m in range(3):
            full = _get_mag(a4, sinv, x, rp, h1e, tsd[si, m], wsd[si, m], 1.0)
            h11[si, m] = contr.T @ full @ contr
    return h10, h11

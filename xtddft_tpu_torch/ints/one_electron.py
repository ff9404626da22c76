"""One-electron integrals over spherical Gaussian AOs.

Provides the integrals the reference obtains from libcint:
- ``overlap``            int1e_ovlp
- ``kinetic``            int1e_kin
- ``nuclear_attraction`` int1e_nuc
- ``dipole``             int1e_r (with selectable origin)
- ``ip_overlap``         int1e_ipovlp  (gradient on the bra)
- ``angular_momentum``   int1e_cg_irxp ((r-G) x nabla, real antisymmetric)
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.ints import mcmurchie as md
from xtddft_tpu_torch.ints.shell import BasisLayout, Shell, cart2sph, cart_components


def _pair_weight(p: np.ndarray, cc: np.ndarray) -> np.ndarray:
    return cc * (np.pi / p) ** 1.5


def _sph_block(mat_cart: np.ndarray, la: int, lb: int) -> np.ndarray:
    Ca = cart2sph(la)
    Cb = cart2sph(lb)
    nca = Ca.shape[0]
    ncb = Cb.shape[0]
    m = mat_cart.reshape(nca, ncb)
    return Ca.T @ m @ Cb


def _assemble(layout: BasisLayout, block_fn, ncomp: int = 1, hermitian: bool = True):
    nao = layout.nao
    if ncomp == 1:
        out = np.zeros((nao, nao))
    else:
        out = np.zeros((ncomp, nao, nao))
    shells = layout.shells
    for isha, sha in enumerate(shells):
        jmax = isha + 1 if hermitian else len(shells)
        for ishb in range(jmax) if hermitian else range(len(shells)):
            shb = shells[ishb]
            blk = block_fn(sha, shb)
            sa = slice(sha.ao_offset, sha.ao_offset + sha.nao)
            sb = slice(shb.ao_offset, shb.ao_offset + shb.nao)
            if ncomp == 1:
                out[sa, sb] = blk
                if hermitian and ishb != isha:
                    out[sb, sa] = blk.T
            else:
                out[:, sa, sb] = blk
                if hermitian and ishb != isha:
                    out[:, sb, sa] = np.transpose(blk, (0, 2, 1))
    return out


# -- overlap / kinetic ------------------------------------------------------

def _overlap_block(sha: Shell, shb: Shell) -> np.ndarray:
    E, a, b, cc, p = md.make_pair_eijk(sha, shb, ldelta=0)
    w = _pair_weight(p, cc)
    ca = cart_components(sha.l)
    cb = cart_components(shb.l)
    out = np.empty((len(ca), len(cb)))
    for i, (ix, iy, iz) in enumerate(ca):
        for j, (jx, jy, jz) in enumerate(cb):
            out[i, j] = np.sum(w * E[0][ix, jx, 0] * E[1][iy, jy, 0] * E[2][iz, jz, 0])
    return _sph_block(out, sha.l, shb.l)


def overlap(layout: BasisLayout) -> np.ndarray:
    return _assemble(layout, _overlap_block)


def _kinetic_block(sha: Shell, shb: Shell) -> np.ndarray:
    E, a, b, cc, p = md.make_pair_eijk(sha, shb, ldelta=2)
    w = _pair_weight(p, cc)
    ca = cart_components(sha.l)
    cb = cart_components(shb.l)

    def s1(d, i, j):
        return E[d][i, j, 0]

    def t1(d, i, j):
        val = b * (2 * j + 1) * s1(d, i, j) - 2.0 * b**2 * s1(d, i, j + 2)
        if j >= 2:
            val = val - 0.5 * j * (j - 1) * s1(d, i, j - 2)
        return val

    out = np.empty((len(ca), len(cb)))
    for i, (ix, iy, iz) in enumerate(ca):
        for j, (jx, jy, jz) in enumerate(cb):
            sx, sy, sz = s1(0, ix, jx), s1(1, iy, jy), s1(2, iz, jz)
            tx, ty, tz = t1(0, ix, jx), t1(1, iy, jy), t1(2, iz, jz)
            out[i, j] = np.sum(w * (tx * sy * sz + sx * ty * sz + sx * sy * tz))
    return _sph_block(out, sha.l, shb.l)


def kinetic(layout: BasisLayout) -> np.ndarray:
    return _assemble(layout, _kinetic_block)


# -- nuclear attraction -----------------------------------------------------

def nuclear_attraction(layout: BasisLayout) -> np.ndarray:
    mol = layout.mol
    charges = mol.charges
    centers = mol.coords

    def block(sha: Shell, shb: Shell) -> np.ndarray:
        sp = md.make_shell_pair(sha, shb)
        L = sp.L
        npair = sp.npair
        acc = np.zeros((sp.H.shape[0],))
        pref = 2.0 * np.pi / sp.p  # (npair,)
        total = np.zeros(sp.H.shape[0])
        for C, Z in zip(centers, charges):
            PC = sp.P - C[None, :]
            R = md.hermite_coulomb(L, sp.p, PC)  # (nherm, npair)
            total = total - Z * np.einsum("chp,hp,p->c", sp.H, R, pref)
        return _sph_block(total, sha.l, shb.l)

    return _assemble(layout, block)


# -- moments ----------------------------------------------------------------

def dipole(layout: BasisLayout, origin=(0.0, 0.0, 0.0)) -> np.ndarray:
    """<mu|(r - origin)|nu>, shape (3, nao, nao), symmetric per component."""
    origin = np.asarray(origin, dtype=np.float64)

    def block(sha: Shell, shb: Shell) -> np.ndarray:
        E, a, b, cc, p = md.make_pair_eijk(sha, shb, ldelta=1)
        w = _pair_weight(p, cc)
        BC = shb.center - origin
        ca = cart_components(sha.l)
        cb = cart_components(shb.l)
        out = np.empty((3, len(ca), len(cb)))
        for i, ci in enumerate(ca):
            for j, cj in enumerate(cb):
                s = [E[d][ci[d], cj[d], 0] for d in range(3)]
                m = [E[d][ci[d], cj[d] + 1, 0] + BC[d] * s[d] for d in range(3)]
                out[0, i, j] = np.sum(w * m[0] * s[1] * s[2])
                out[1, i, j] = np.sum(w * s[0] * m[1] * s[2])
                out[2, i, j] = np.sum(w * s[0] * s[1] * m[2])
        return np.stack(
            [_sph_block(out[x], sha.l, shb.l) for x in range(3)], axis=0
        )

    return _assemble(layout, block, ncomp=3)


# -- derivative integrals ---------------------------------------------------

def ip_overlap(layout: BasisLayout) -> np.ndarray:
    """<d/dr mu | nu>, shape (3, nao, nao); antisymmetric overall."""

    def block(sha: Shell, shb: Shell) -> np.ndarray:
        E, a, b, cc, p = md.make_pair_eijk(sha, shb, ldelta=1)
        w = _pair_weight(p, cc)
        ca = cart_components(sha.l)
        cb = cart_components(shb.l)
        out = np.empty((3, len(ca), len(cb)))
        for i, ci in enumerate(ca):
            for j, cj in enumerate(cb):
                s = [E[d][ci[d], cj[d], 0] for d in range(3)]
                dv = []
                for d in range(3):
                    val = -2.0 * a * E[d][ci[d] + 1, cj[d], 0]
                    if ci[d] >= 1:
                        val = val + ci[d] * E[d][ci[d] - 1, cj[d], 0]
                    dv.append(val)
                out[0, i, j] = np.sum(w * dv[0] * s[1] * s[2])
                out[1, i, j] = np.sum(w * s[0] * dv[1] * s[2])
                out[2, i, j] = np.sum(w * s[0] * s[1] * dv[2])
        return np.stack(
            [_sph_block(out[x], sha.l, shb.l) for x in range(3)], axis=0
        )

    return _assemble(layout, block, ncomp=3, hermitian=False)


def angular_momentum(layout: BasisLayout, gauge_origin=(0.0, 0.0, 0.0)) -> np.ndarray:
    """<mu| (r-G) x nabla |nu> (real, antisymmetric), shape (3, nao, nao)."""
    G = np.asarray(gauge_origin, dtype=np.float64)

    def block(sha: Shell, shb: Shell) -> np.ndarray:
        E, a, b, cc, p = md.make_pair_eijk(sha, shb, ldelta=1)
        w = _pair_weight(p, cc)
        BG = shb.center - G
        ca = cart_components(sha.l)
        cb = cart_components(shb.l)
        out = np.empty((3, len(ca), len(cb)))
        for i, ci in enumerate(ca):
            for j, cj in enumerate(cb):
                s = [E[d][ci[d], cj[d], 0] for d in range(3)]
                # ket moment (r_d - G_d) and ket derivative d/d r_d
                mom = [E[d][ci[d], cj[d] + 1, 0] + BG[d] * s[d] for d in range(3)]
                der = []
                for d in range(3):
                    val = -2.0 * b * E[d][ci[d], cj[d] + 1, 0]
                    if cj[d] >= 1:
                        val = val + cj[d] * E[d][ci[d], cj[d] - 1, 0]
                    der.append(val)
                # L_x = y dz - z dy ; L_y = z dx - x dz ; L_z = x dy - y dx
                out[0, i, j] = np.sum(w * s[0] * (mom[1] * der[2] - mom[2] * der[1]))
                out[1, i, j] = np.sum(w * s[1] * (mom[2] * der[0] - mom[0] * der[2]))
                out[2, i, j] = np.sum(w * s[2] * (mom[0] * der[1] - mom[1] * der[0]))
        return np.stack(
            [_sph_block(out[x], sha.l, shb.l) for x in range(3)], axis=0
        )

    return _assemble(layout, block, ncomp=3, hermitian=False)


def ip_kinetic(layout: BasisLayout) -> np.ndarray:
    """<d/dr mu | T | nu>, shape (3, nao, nao) (int1e_ipkin analog)."""

    def block(sha: Shell, shb: Shell) -> np.ndarray:
        E, a, b, cc, p = md.make_pair_eijk(sha, shb, ldelta=3)
        w = _pair_weight(p, cc)
        ca = cart_components(sha.l)
        cb = cart_components(shb.l)

        def s1(d, i, j):
            return E[d][i, j, 0]

        def t1(d, i, j):
            val = b * (2 * j + 1) * s1(d, i, j) - 2.0 * b**2 * s1(d, i, j + 2)
            if j >= 2:
                val = val - 0.5 * j * (j - 1) * s1(d, i, j - 2)
            return val

        def ds1(d, i, j):
            val = -2.0 * a * s1(d, i + 1, j)
            if i >= 1:
                val = val + i * s1(d, i - 1, j)
            return val

        def dt1(d, i, j):
            val = -2.0 * a * t1(d, i + 1, j)
            if i >= 1:
                val = val + i * t1(d, i - 1, j)
            return val

        out = np.empty((3, len(ca), len(cb)))
        for i, ci in enumerate(ca):
            for j, cj in enumerate(cb):
                s = [s1(d, ci[d], cj[d]) for d in range(3)]
                t = [t1(d, ci[d], cj[d]) for d in range(3)]
                for x in range(3):
                    fac = []
                    for d in range(3):
                        if d == x:
                            fac.append((ds1(d, ci[d], cj[d]),
                                        dt1(d, ci[d], cj[d])))
                        else:
                            fac.append((s[d], t[d]))
                    # T = tx*sy*sz + sx*ty*sz + sx*sy*tz with the x-factor
                    # replaced by its derivative
                    term = (
                        fac[0][1] * fac[1][0] * fac[2][0]
                        + fac[0][0] * fac[1][1] * fac[2][0]
                        + fac[0][0] * fac[1][0] * fac[2][1]
                    )
                    out[x, i, j] = np.sum(w * term)
        return np.stack(
            [_sph_block(out[x], sha.l, shb.l) for x in range(3)], axis=0
        )

    return _assemble(layout, block, ncomp=3, hermitian=False)


def ip_rinv(layout: BasisLayout, center) -> np.ndarray:
    """<d/dr mu | 1/|r-C| | nu>, shape (3, nao, nao) (positive kernel)."""
    C = np.asarray(center, dtype=np.float64)

    def block(sha: Shell, shb: Shell) -> np.ndarray:
        out = np.empty((3, sha.nao, shb.nao))
        for d in range(3):
            sp = md.make_shell_pair_deriv(sha, shb, d_bra=d)
            PC = sp.P - C[None, :]
            R = md.hermite_coulomb(sp.L, sp.p, PC)
            blk = np.einsum("chp,hp,p->c", sp.H, R, 2.0 * np.pi / sp.p)
            out[d] = _sph_block(blk, sha.l, shb.l)
        return out

    return _assemble(layout, block, ncomp=3, hermitian=False)

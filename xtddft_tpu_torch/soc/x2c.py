"""Spin-free exact-two-component (sfX2C) one-electron decoupling.

Counterpart of the JAX package's `soc/x2c.py`, a re-derivation of
`x2c_hamiltonian/sfX2C_soDKH1.py:150-201` (JCP 137, 154114 (2012) Eqs.
38-50): solve the 2n x 2n generalized eigenproblem of the
four-component-like one-electron matrix, extract the decoupling X and the
renormalization R+, and form the picture-changed h1e.  Includes the basis
uncontraction (the reference delegates to PySCF ``with_x2c.get_xmol``).
Host numpy/scipy in f64: the matrices are of the uncontracted basis's size.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from xtddft_tpu_torch.ints.shell import BasisLayout, Shell, nsph, primitive_norm


def uncontract(layout: BasisLayout):
    """Fully decontracted layout + contraction-coefficient matrix.

    Returns (unc_layout, contr) with contr of shape (nao_unc, nao) so that
    contracted integrals are ``contr.T @ M_unc @ contr``.  Duplicate
    exponents within one (atom, l) group are merged to keep the
    uncontracted overlap nonsingular (PySCF's get_xmol does the same)."""
    mol = layout.mol
    # unique primitives per (atom, l), in discovery order
    prim_index: dict = {}
    unc_shells: list[Shell] = []
    offset = 0
    for sh in layout.shells:
        for e in sh.exps:
            key = (sh.atom_index, sh.l, float(e))
            if key in prim_index:
                continue
            prim_index[key] = len(unc_shells)
            unc_shells.append(Shell(
                l=sh.l, center=sh.center, exps=np.array([e]),
                coefs=np.array([primitive_norm(np.array([e]), sh.l)[0]]),
                atom_index=sh.atom_index, ao_offset=offset))
            offset += nsph(sh.l)
    unc = BasisLayout(mol=mol, shells=tuple(unc_shells), nao=offset)

    contr = np.zeros((unc.nao, layout.nao))
    for sh in layout.shells:
        norms = primitive_norm(sh.exps, sh.l)
        for e, c, N in zip(sh.exps, sh.coefs, norms):
            ush = unc_shells[prim_index[(sh.atom_index, sh.l, float(e))]]
            for m in range(nsph(sh.l)):
                contr[ush.ao_offset + m, sh.ao_offset + m] += c / N
    return unc, contr


def inv12(S: np.ndarray) -> np.ndarray:
    """S^(-1/2) by symmetric orthogonalization."""
    w, U = np.linalg.eigh(S)
    return (U / np.sqrt(w)) @ U.T


def sfx2c1e(t, v, w, s, c):
    """One-step sfX2C decoupling.  Returns (X, R+, h1e).

    t/v/s: kinetic / nuclear / overlap; w: p.Vnuc.p; c: speed of light
    (`sfX2C_soDKH1.py:150-183`, JCP 137 154114 Eqs. 38-48)."""
    nao = s.shape[0]
    n2 = 2 * nao
    h = np.zeros((n2, n2))
    m = np.zeros((n2, n2))
    h[:nao, :nao] = v
    h[:nao, nao:] = t
    h[nao:, :nao] = t
    h[nao:, nao:] = w * (0.25 / c**2) - t
    m[:nao, :nao] = s
    m[nao:, nao:] = t * (0.5 / c**2)
    _, a = scipy.linalg.eigh(h, m)
    cl = a[:nao, nao:]
    cs = a[nao:, nao:]
    x = cs @ cl.T @ np.linalg.inv(cl @ cl.T)
    stilde = s + x.T @ (m[nao:, nao:] @ x)
    sih = inv12(s)
    sh = np.linalg.inv(sih)
    rp = sih @ inv12(sih @ stilde @ sih) @ sh
    l1e = (h[:nao, :nao] + h[:nao, nao:] @ x + x.T @ h[nao:, :nao]
           + x.T @ (h[nao:, nao:] @ x))
    h1e = rp.T @ l1e @ rp
    return x, rp, h1e


def get_p(dm, x, rp):
    """Spin-averaged large/small-component densities pLL/pLS/pSS
    (`sfX2C_soDKH1.py:185-200`, Eq. 50)."""
    pLL = rp @ dm @ rp.T
    pLS = pLL @ x.T
    pSS = x @ pLL @ x.T
    return pLL, pLS, pSS


def sfx2c_hcore(layout: BasisLayout, c: float) -> np.ndarray:
    """Picture-changed spin-free X2C one-electron Hamiltonian in the
    contracted AO basis: decouple in the fully uncontracted basis, then
    project back through the contraction coefficients (JAX `scf/env.py:71
    Env._sfx2c_hcore`)."""
    from xtddft_tpu_torch.ints import kinetic, nuclear_attraction, overlap
    from xtddft_tpu_torch.ints.soc_ints import nuclear_deriv2

    unc, contr = uncontract(layout)
    w_sf, _ = nuclear_deriv2(unc)
    _, _, h1e = sfx2c1e(kinetic(unc), nuclear_attraction(unc), w_sf, overlap(unc), c)
    return contr.T @ h1e @ contr

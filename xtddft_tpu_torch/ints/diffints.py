"""Differentiable Gaussian integrals: torch McMurchie-Davidson in the nuclear coordinates.

Counterpart of the JAX package's `ints/jaxints.py`.  The host engine
(`ints/mcmurchie.py`, the native `xtddft_native/md_eri.cpp`) computes
integrals at a fixed geometry; here S, T, V, the spin-free pVp block and the
full ERI tensor are plain torch functions of the atomic coordinates, so that
autograd gives nuclear derivatives of any energy built on them.  The shell
structure (angular momenta, exponents, contractions) is static; only the
centres are differentiated.  The work is vectorized over the shell pairs of
one (la, lb, primitive-count bucket) class, as in JAX.

``make_integral_fn`` loops over the pair classes (and for the ERIs over
class pairs, each unordered pair once, its bra<->ket mirror scattered from
the same block).  JAX's ``block_jit`` has no counterpart: torch runs the loop
eagerly either way.  The pair axis of a class is not padded to a power of
two (the padding served JAX's executable reuse only).

This module is the plain version of K5 `eri_grad` (`kernels/eri_grad.py`),
whose vjp in the coordinates it computes by autograd, and the gradient's
route for CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xtddft_tpu_torch.ints.mcmurchie import herm_index_map, herm_indices
from xtddft_tpu_torch.ints.shell import BasisLayout, cart2sph, cart_components, ncart
from xtddft_tpu_torch.ints.soc_ints import _boys_t, hermite_coulomb_t

__all__ = ["boys_t", "make_integral_fn", "make_eri_fn"]


# -- Boys function (differentiable) -----------------------------------------

class _Boys(torch.autograd.Function):
    """F_m(x), m = 0..mmax, with dF_m/dx = -F_{m+1}(x): the values of the
    host engine's closed form (`soc_ints._boys_t`) and an exact first
    derivative (autograd through the incomplete gamma's quotient cancels
    digits at small x)."""

    @staticmethod
    def forward(x, mmax):
        return _boys_t(mmax + 1, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (f,) = ctx.saved_tensors
        return -(g[:-1] * f[1:]).sum(0), None


def boys_t(mmax: int, x: torch.Tensor) -> torch.Tensor:
    """F_m(x) for m = 0..mmax, shape (mmax+1,) + x.shape (JAX `boys_jax`)."""
    return _Boys.apply(x, mmax)[:-1]


# -- Hermite expansion coefficients ------------------------------------------

def _e_coeffs(la: int, lb: int, a, b, AB):
    """E[i][j][t] per dimension, each of the broadcast shape of a, b, AB
    (pairs x primitive pairs); the recursion of `mcmurchie.e_coeffs_1d`."""
    p = a + b
    mu = a * b / p
    XPA = -b / p * AB
    XPB = a / p * AB
    inv2p = 0.5 / p
    E = [[[None] * (la + lb + 1) for _ in range(lb + 1)] for _ in range(la + 1)]

    def get(i, j, t):
        if t < 0 or t > i + j:
            return 0.0
        v = E[i][j][t]
        return 0.0 if v is None else v

    E[0][0][0] = torch.exp(-mu * AB * AB)
    for i in range(1, la + 1):
        for t in range(i + 1):
            val = XPA * get(i - 1, 0, t)
            if t > 0:
                val = val + inv2p * get(i - 1, 0, t - 1)
            if t + 1 <= i - 1:
                val = val + (t + 1) * get(i - 1, 0, t + 1)
            E[i][0][t] = val
    for j in range(1, lb + 1):
        for i in range(la + 1):
            for t in range(i + j + 1):
                val = XPB * get(i, j - 1, t)
                if t > 0:
                    val = val + inv2p * get(i, j - 1, t - 1)
                if t + 1 <= i + j - 1:
                    val = val + (t + 1) * get(i, j - 1, t + 1)
                E[i][j][t] = val
    return E


def _hermite_coulomb(L: int, alpha, PQ, omega: float = 0.0):
    """R_{tuv}(alpha, PQ) for all t+u+v <= L, stacked on a last axis in
    `herm_indices(L)` order (JAX `_hermite_coulomb` then `_stack_R`);
    ``omega`` > 0: the erf(omega r)/r kernel."""
    shape = PQ.shape[:-1]
    alpha = alpha.expand(shape)
    R = hermite_coulomb_t(L, alpha.reshape(-1), PQ.reshape(-1, 3), omega=omega, boys=boys_t)
    return R.reshape(R.shape[0], *shape).movedim(0, -1)


# -- shell-pair classes -------------------------------------------------------

class _PairClass:
    """Static data of the ordered shell pairs of one (la, lb, primitive
    bucket) class.  Pairs with fewer primitive products than the class's
    most are padded with (exp 1, coefficient 0) entries, which add exactly
    zero."""

    def __init__(self, la, lb):
        self.la, self.lb = la, lb
        self.exps_a, self.exps_b, self.cc = [], [], []
        self.ia, self.ib = [], []
        self.ao_a, self.ao_b = [], []
        self._dev = {}

    def add(self, sha, shb, ab2=0.0, prim_eps=0.0):
        ea = np.repeat(sha.exps, len(shb.exps))
        eb = np.tile(shb.exps, len(sha.exps))
        cc = np.repeat(sha.coefs, len(shb.coefs)) * np.tile(shb.coefs, len(sha.coefs))
        if prim_eps > 0.0:
            # primitive-pair overlap screening at the build geometry (the
            # host engine's bound); the pattern is frozen there, which is
            # exact for gradients taken at that geometry
            p = ea + eb
            est = np.abs(cc) * (np.pi / p) ** 1.5 * np.exp(-ea * eb / p * ab2)
            keep = est >= prim_eps
            if not keep.any():
                keep[np.argmax(est)] = True
            ea, eb, cc = ea[keep], eb[keep], cc[keep]
        self.exps_a.append(ea)
        self.exps_b.append(eb)
        self.cc.append(cc)
        self.ia.append(sha.atom_index)
        self.ib.append(shb.atom_index)
        self.ao_a.append(sha.ao_offset)
        self.ao_b.append(shb.ao_offset)

    def finalize(self):
        npp = max(len(e) for e in self.exps_a)

        def pad(arrs, fill):
            return np.asarray([np.concatenate([a, np.full(npp - len(a), fill)]) for a in arrs])

        self.exps_a = pad(self.exps_a, 1.0)  # (npair, npp)
        self.exps_b = pad(self.exps_b, 1.0)
        self.cc = pad(self.cc, 0.0)
        self.ia = np.asarray(self.ia)
        self.ib = np.asarray(self.ib)
        self.idx_a = np.asarray(self.ao_a)[:, None] + np.arange(2 * self.la + 1)[None, :]
        self.idx_b = np.asarray(self.ao_b)[:, None] + np.arange(2 * self.lb + 1)[None, :]
        return self

    def on(self, like: torch.Tensor) -> dict:
        """The class's arrays as tensors on ``like``'s device and dtype."""
        key = (like.device, like.dtype)
        if key not in self._dev:
            def t(x):
                return torch.as_tensor(x, dtype=like.dtype, device=like.device)
            self._dev[key] = {
                "a": t(self.exps_a), "b": t(self.exps_b), "cc": t(self.cc),
                "ia": torch.as_tensor(self.ia, device=like.device),
                "ib": torch.as_tensor(self.ib, device=like.device),
                "ca": t(cart2sph(self.la)), "cb": t(cart2sph(self.lb))}
        return self._dev[key]


def _npp_bucket(n: int) -> int:
    """Next power of 4 >= n: pairs are grouped by primitive-product count so
    that a one-primitive pair never pads to a 9x9 class."""
    b = 1
    while b < n:
        b *= 4
    return b


def _pair_classes(layout: BasisLayout, prim_eps: float = 1e-14):
    coords = np.asarray(layout.mol.coords, dtype=np.float64)
    classes: dict = {}
    for sha in layout.shells:
        for shb in layout.shells:
            ab2 = float(np.sum((coords[sha.atom_index] - coords[shb.atom_index]) ** 2))
            ea = np.repeat(sha.exps, len(shb.exps))
            eb = np.tile(shb.exps, len(sha.exps))
            cc = np.abs(np.repeat(sha.coefs, len(shb.coefs)) * np.tile(shb.coefs, len(sha.coefs)))
            p = ea + eb
            est = cc * (np.pi / p) ** 1.5 * np.exp(-ea * eb / p * ab2)
            nkeep = max(1, int((est >= prim_eps).sum())) if prim_eps > 0 else len(ea)
            key = (sha.l, shb.l, _npp_bucket(nkeep))
            classes.setdefault(key, _PairClass(key[0], key[1])).add(
                sha, shb, ab2=ab2, prim_eps=prim_eps)
    return [c.finalize() for c in classes.values()]


def _pair_geometry(pc: _PairClass, coords):
    d = pc.on(coords)
    A = coords[d["ia"]]  # (npair, 3)
    B = coords[d["ib"]]
    a, b = d["a"], d["b"]
    p = a + b
    P = (a[..., None] * A[:, None, :] + b[..., None] * B[:, None, :]) / p[..., None]
    return a, b, p, P, A - B


def _pair_hermite(pc: _PairClass, a, b, AB, ldelta=0):
    return tuple(_e_coeffs(pc.la + ldelta, pc.lb + ldelta, a, b, AB[:, k:k + 1])
                 for k in range(3))


def _cart_to_sph_pair(pc, M):
    """(npair, ncart_a, ncart_b) -> (npair, nsph_a, nsph_b)."""
    d = pc.on(M)
    return torch.einsum("ncd,cm,dk->nmk", M, d["ca"], d["cb"])


def _scatter2(full, pc, blk):
    ia = torch.as_tensor(pc.idx_a[:, :, None], device=full.device)
    ib = torch.as_tensor(pc.idx_b[:, None, :], device=full.device)
    ia, ib = torch.broadcast_tensors(ia, ib)
    return full.index_put((ia, ib), blk, accumulate=True)


# -- one-electron integrals ---------------------------------------------------

def _overlap_kinetic(pc: _PairClass, coords):
    a, b, p, P, AB = _pair_geometry(pc, coords)
    Ex, Ey, Ez = _pair_hermite(pc, a, b, AB, ldelta=2)
    pref = (math.pi / p) ** 1.5 * pc.on(coords)["cc"]

    def s1(E, i, j):
        return E[i][j][0]

    def d2(E, i, j):
        t = 4.0 * b * b * s1(E, i, j + 2) - 2.0 * b * (2 * j + 1) * s1(E, i, j)
        if j >= 2:
            t = t + j * (j - 1) * s1(E, i, j - 2)
        return t

    S_rows, T_rows = [], []
    for (ix, iy, iz) in cart_components(pc.la):
        S_row, T_row = [], []
        for (jx, jy, jz) in cart_components(pc.lb):
            sx, sy, sz = s1(Ex, ix, jx), s1(Ey, iy, jy), s1(Ez, iz, jz)
            S_row.append(torch.sum(pref * sx * sy * sz, dim=-1))
            tx = d2(Ex, ix, jx) * sy * sz
            ty = sx * d2(Ey, iy, jy) * sz
            tz = sx * sy * d2(Ez, iz, jz)
            T_row.append(-0.5 * torch.sum(pref * (tx + ty + tz), dim=-1))
        S_rows.append(torch.stack(S_row, dim=-1))
        T_rows.append(torch.stack(T_row, dim=-1))
    S_blk = torch.stack(S_rows, dim=-2)  # (npair, ncart_a, ncart_b)
    T_blk = torch.stack(T_rows, dim=-2)
    return _cart_to_sph_pair(pc, S_blk), _cart_to_sph_pair(pc, T_blk)


def _pair_H(pc: _PairClass, a, b, AB):
    """Dense Hermite table H (npair, ncart_ab, nherm, npp) for L = la+lb,
    contraction weights folded in."""
    Ex, Ey, Ez = _pair_hermite(pc, a, b, AB)
    hidx = herm_indices(pc.la + pc.lb)
    cc = pc.on(a)["cc"]
    zero = torch.zeros_like(cc)
    rows = []
    for (ix, iy, iz) in cart_components(pc.la):
        for (jx, jy, jz) in cart_components(pc.lb):
            hrow = [zero if (t > ix + jx or u > iy + jy or v > iz + jz)
                    else Ex[ix][jx][t] * Ey[iy][jy][u] * Ez[iz][jz][v] * cc
                    for (t, u, v) in hidx]
            rows.append(torch.stack(hrow, dim=1))  # (npair, nherm, npp)
    return torch.stack(rows, dim=1), hidx


def _nuclear_from_H(pc, H, p, P, coords, charges, L):
    PQ = P[:, :, None, :] - coords[None, None, :, :]  # (npair, npp, natm, 3)
    Rd = _hermite_coulomb(L, p[:, :, None], PQ)  # (npair, npp, natm, nherm)
    pref = 2.0 * math.pi / p
    z = torch.as_tensor(charges, dtype=coords.dtype, device=coords.device)
    flat = -torch.einsum("nAhp,np,npCh,C->nA", H, pref, Rd, z)
    return _cart_to_sph_pair(pc, flat.reshape(-1, ncart(pc.la), ncart(pc.lb)))


def _nuclear(pc: _PairClass, coords, charges):
    a, b, p, P, AB = _pair_geometry(pc, coords)
    H, _ = _pair_H(pc, a, b, AB)
    return _nuclear_from_H(pc, H, p, P, coords, charges, pc.la + pc.lb)


def _pvp(pc: _PairClass, coords, charges):
    """Spin-free pVp block W_mu_nu = sum_x <d_x mu| V_nuc |d_x nu>,
    V_nuc = -sum_C Z_C / r_C (the sfX2C small-small potential): the bra x
    ket derivative pair on E tables one index higher, Hermite depth L+2."""
    a, b, p, P, AB = _pair_geometry(pc, coords)
    Ex, Ey, Ez = _pair_hermite(pc, a, b, AB, ldelta=1)
    cc = pc.on(coords)["cc"]
    la, lb = pc.la, pc.lb
    L = la + lb + 2
    zero = torch.zeros_like(cc * AB[:, 0:1])

    def g(Et, i, j, t):
        if i < 0 or j < 0 or t < 0 or t > i + j:
            return None
        return Et[i][j][t]

    def D(Et, i, j, t):
        """(d_x bra_i)(d_x ket_j) pair-derivative E coefficient."""
        out = zero
        v = g(Et, i - 1, j - 1, t)
        if v is not None and i and j:
            out = out + (i * j) * v
        v = g(Et, i - 1, j + 1, t)
        if v is not None and i:
            out = out - (2.0 * i) * b * v
        v = g(Et, i + 1, j - 1, t)
        if v is not None and j:
            out = out - (2.0 * j) * a * v
        v = g(Et, i + 1, j + 1, t)
        if v is not None:
            out = out + 4.0 * a * b * v
        return out

    def E0(Et, i, j, t):
        v = g(Et, i, j, t)
        return zero if v is None else v

    rows = []
    for (ix, iy, iz) in cart_components(la):
        for (jx, jy, jz) in cart_components(lb):
            hrow = []
            for (t, u, v) in herm_indices(L):
                val = (D(Ex, ix, jx, t) * E0(Ey, iy, jy, u) * E0(Ez, iz, jz, v)
                       + E0(Ex, ix, jx, t) * D(Ey, iy, jy, u) * E0(Ez, iz, jz, v)
                       + E0(Ex, ix, jx, t) * E0(Ey, iy, jy, u) * D(Ez, iz, jz, v))
                hrow.append(val * cc)
            rows.append(torch.stack(hrow, dim=1))
    H = torch.stack(rows, dim=1)  # (npair, ncart_ab, nherm, npp)
    return _nuclear_from_H(pc, H, p, P, coords, charges, L)


# -- two-electron integrals ---------------------------------------------------

def _eri_block(pc1: _PairClass, pc2: _PairClass, coords, omega: float = 0.0):
    """(n1, nsph_a, nsph_b, n2, nsph_c, nsph_d) ERI block over two ordered
    pair classes (chemists' notation (ab|cd))."""
    a1, b1, p1, P1, AB1 = _pair_geometry(pc1, coords)
    a2, b2, p2, P2, AB2 = _pair_geometry(pc2, coords)
    H1, hidx1 = _pair_H(pc1, a1, b1, AB1)
    H2, hidx2 = _pair_H(pc2, a2, b2, AB2)
    L1, L2 = pc1.la + pc1.lb, pc2.la + pc2.lb
    p1e = p1[:, :, None, None]
    p2e = p2[None, None, :, :]
    alpha = p1e * p2e / (p1e + p2e)
    PQ = P1[:, :, None, None, :] - P2[None, None, :, :, :]
    Rd = _hermite_coulomb(L1 + L2, alpha, PQ, omega=omega)  # (n1, p1, n2, p2, nherm12)
    pref = 2.0 * math.pi ** 2.5 / (p1e * p2e * torch.sqrt(p1e + p2e))
    Rd = Rd * pref[..., None]

    # combined-index gather M[h1, h2] -> h12, and the ket parity
    hmap = herm_index_map(L1 + L2)
    M = np.empty((len(hidx1), len(hidx2)), dtype=np.int64)
    for i1, (t1, u1, v1) in enumerate(hidx1):
        for i2, (t2, u2, v2) in enumerate(hidx2):
            M[i1, i2] = hmap[(t1 + t2, u1 + u2, v1 + v2)]
    sgn = torch.as_tensor([(-1.0) ** sum(tuv) for tuv in hidx2], dtype=coords.dtype,
                          device=coords.device)
    H2s = H2 * sgn[None, None, :, None]
    Rg = Rd[..., torch.as_tensor(M, device=coords.device)]  # (n1, p1, n2, p2, nh1, nh2)
    tmp = torch.einsum("mBgq,npmqhg->npmBh", H2s, Rg)
    cart = torch.einsum("nAhp,npmBh->nAmB", H1, tmp)
    cart = cart.reshape(cart.shape[0], ncart(pc1.la), ncart(pc1.lb), cart.shape[2],
                        ncart(pc2.la), ncart(pc2.lb))
    d1, d2 = pc1.on(coords), pc2.on(coords)
    return torch.einsum("nabmcd,ax,by,cz,dw->nxymzw", cart, d1["ca"], d1["cb"], d2["ca"],
                        d2["cb"])


def _flat_index(nao, ia, ib, ic, id_):
    """Flat index of (nao,)*4 positions for a (n1, na, nb, n2, nc, nd) block."""
    return (((ia[:, :, None, None, None, None] * nao + ib[:, None, :, None, None, None]) * nao
             + ic[None, None, None, :, :, None]) * nao + id_[None, None, None, :, None, :])


def make_eri_fn(layout: BasisLayout, omega: float = 0.0, classes=None):
    """Return ``eri(coords) -> (nao, nao, nao, nao)`` differentiable in
    ``coords``: each unordered pair of pair classes once, the (cd|ab) mirror
    written from the (ab|cd) block; every element is written exactly once
    by one index_put."""
    classes = _pair_classes(layout) if classes is None else classes
    nao = layout.nao
    plan = []
    for i1, pc1 in enumerate(classes):
        for i2 in range(i1, len(classes)):
            pc2 = classes[i2]
            idx = [_flat_index(nao, pc1.idx_a, pc1.idx_b, pc2.idx_a, pc2.idx_b).reshape(-1)]
            if i2 > i1:
                fwd = _flat_index(nao, pc2.idx_a, pc2.idx_b, pc1.idx_a, pc1.idx_b)
                idx.append(np.moveaxis(fwd, (0, 1, 2), (3, 4, 5)).reshape(-1))
            plan.append((pc1, pc2, idx))
    index = np.concatenate([i for _, _, idx in plan for i in idx])
    index_dev = {}

    def eri(coords):
        key = coords.device
        if key not in index_dev:
            index_dev[key] = torch.as_tensor(index, device=coords.device)
        vals = []
        for pc1, pc2, idx in plan:
            blk = _eri_block(pc1, pc2, coords, omega=omega).reshape(-1)
            vals.extend([blk] * len(idx))
        out = coords.new_zeros(nao ** 4)
        out = out.index_put((index_dev[key],), torch.cat(vals))
        return out.reshape(nao, nao, nao, nao)

    return eri


def make_integral_fn(layout: BasisLayout, do_eri: bool = True, omega_lr: float = 0.0):
    """Return ``ints(coords) -> dict(S, T, V, coords[, eri][, eri_lr])``,
    differentiable in ``coords`` (natm, 3, bohr; its device and dtype are
    the integrals').  Spherical AO basis, the host engine's conventions.
    ``omega_lr`` > 0 adds the erf(omega r)/r ERIs as 'eri_lr' (range-
    separated hybrids)."""
    classes = _pair_classes(layout)
    nao = layout.nao
    charges = np.asarray(layout.mol.charges, dtype=np.float64)
    eri_fns = {}
    if do_eri:
        eri_fns["eri"] = make_eri_fn(layout, 0.0, classes)
        if omega_lr and omega_lr > 0.0:
            eri_fns["eri_lr"] = make_eri_fn(layout, omega_lr, classes)

    def ints(coords):
        S = coords.new_zeros((nao, nao))
        T = coords.new_zeros((nao, nao))
        V = coords.new_zeros((nao, nao))
        for pc in classes:
            S_blk, T_blk = _overlap_kinetic(pc, coords)
            S = _scatter2(S, pc, S_blk)
            T = _scatter2(T, pc, T_blk)
            V = _scatter2(V, pc, _nuclear(pc, coords, charges))
        out = {"S": S, "T": T, "V": V, "coords": coords}
        for key, fn in eri_fns.items():
            out[key] = fn(coords)
        return out

    return ints

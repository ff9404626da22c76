"""Spin-orbit / X2C derivative integrals, batched by angular-momentum class.

Counterpart of the JAX package's `ints/soc_ints.py`: the integrals the
reference takes from libcint for its relativistic layer
(`x2c_hamiltonian/sfX2C_soDKH1.py`):

- ``rinv_deriv2``  <d_i mu | 1/r_C | d_j nu>            (cint1e_iprinvip-like)
- ``pnucp``        p.Vnuc.p spin-free W                  (int1e_pnucp, :761)
- ``wso``          eps_lmn <d_m mu| Vnuc |d_n nu>        (cint1e_prinvxp, :202-216)
- ``kint``         eps_lij (d_i mu nu | d_j ka la)       (int2e_ip1ip2, :218-243)

The integrals are the JAX package's (McMurchie-Davidson derivative shell
pairs), but computed a class at a time where the JAX package loops over
single shell pairs and quartets in Python:

- one-electron: every ordered shell pair of one class (la, lb) at once, over
  its primitive pairs laid end to end (`one_electron._batches`), with every
  nucleus in one Hermite recursion and the charges folded in before the
  contraction (``nuclear_deriv2`` needs only the charge-weighted sum);
- two-electron: every shell quartet of one class (la, lb, lc, ld) at once.
  The derivative pairs' Hermite expansions are built on the host per pair
  class; the Hermite-Coulomb tensor R of a whole chunk of quartets comes
  from one vectorized recursion (``hermite_coulomb_t``) on the requested
  torch device, and the two contractions with the pairs' expansions are
  batched matrix products there.  ``kint_class_blocks`` yields the chunks;
  `soc/somf.py fso2e_direct` accumulates the mean-field contraction from
  them, so the 3 nao^4 tensor is never formed.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from xtddft_tpu_torch import config
from xtddft_tpu_torch.ints import mcmurchie as md
from xtddft_tpu_torch.ints.mcmurchie import herm_index_map, herm_indices
from xtddft_tpu_torch.ints.one_electron import _batches, _components, _make_batch, _ncart
from xtddft_tpu_torch.ints.shell import BasisLayout, cart2sph
from xtddft_tpu_torch.ints.two_electron import _comb_index, _herm_sign

_EPS = np.zeros((3, 3, 3))
for _x, _y, _z in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
    _EPS[_x, _y, _z] = 1.0
    _EPS[_x, _z, _y] = -1.0

# (component pairs x primitive pairs) of one one-electron batch, and
# elements of the largest intermediate of one two-electron chunk
_QUARTET_ELEMS = 1 << 24


def _nherm(L: int) -> int:
    return (L + 1) * (L + 2) * (L + 3) // 6


# -- derivative Hermite expansions, a class at a time -----------------------

def _deriv_table(E, la, lb, a, b, bra, ket, tmax: int) -> np.ndarray:
    """One dimension's E table of (op_bra chi_a) (op_ket chi_b) over the
    undifferentiated index ranges, (la+1, lb+1, tmax, nprim), as
    `mcmurchie.make_shell_pair_deriv` forms it: ``bra`` None, "d" (d/dx) or
    "m" (the moment x - A_x), ``ket`` None or "d" (a term whose factor i or
    j is zero reads index 0 and adds nothing)."""
    i = np.arange(la + 1)[:, None]
    j = np.arange(lb + 1)[None, :]
    im, jm = np.maximum(i - 1, 0), np.maximum(j - 1, 0)
    fi = i[..., None, None].astype(np.float64)
    fj = j[..., None, None].astype(np.float64)
    if bra == "d" and ket:
        v = 4.0 * a * b * E[i + 1, j + 1, :tmax]
        v = v - 2.0 * a * fj * E[i + 1, jm, :tmax]
        v = v - 2.0 * b * fi * E[im, j + 1, :tmax]
        return v + fi * fj * E[im, jm, :tmax]
    if bra == "d":
        return -2.0 * a * E[i + 1, j, :tmax] + fi * E[im, j, :tmax]
    if bra == "m" and ket:
        return -2.0 * b * E[i + 1, j + 1, :tmax] + fj * E[i + 1, jm, :tmax]
    if bra == "m":
        return E[i + 1, j, :tmax]
    if ket:
        return -2.0 * b * E[i, j + 1, :tmax] + fj * E[i, jm, :tmax]
    return E[i, j, :tmax]


def _hermite(D, la: int, lb: int, L: int) -> np.ndarray:
    """(nca * ncb, nherm(L), nprim) Hermite expansion of every component
    pair from the three dimensions' tables, rows a-major."""
    ci, cj = _components(la, lb)
    h = np.asarray(herm_indices(L))
    H = (D[0][ci[..., 0, None], cj[..., 0, None], h[:, 0]]
         * D[1][ci[..., 1, None], cj[..., 1, None], h[:, 1]]
         * D[2][ci[..., 2, None], cj[..., 2, None], h[:, 2]])
    return H.reshape(-1, len(h), H.shape[-1])


def _pair_rows(pairs, which: int, l: int) -> np.ndarray:
    """(npairs, 2l+1) AO indices of the bra (which=2) or ket (which=3) shell
    of each pair (i, j, shell_i, shell_j)."""
    off = np.array([pr[which].ao_offset for pr in pairs], dtype=np.int64)
    return off[:, None] + np.arange(2 * l + 1)[None, :]


# -- one-electron: <d_i mu | 1/r_C | d_j nu> --------------------------------

def _nuclear_sum(layout: BasisLayout, centers, weights, ops, moment_origin=None) -> np.ndarray:
    """(len(ops), nao, nao): sum_C w_C <op_bra mu | 1/|r-C| | op_ket nu> for
    each (bra, ket) of ``ops``, each a (kind, axis) pair or None, kinds as
    `_deriv_table`'s ("d" or "m" on the bra, "d" on the ket).  With
    ``moment_origin`` G a bra moment is (r - G)_axis instead of (r - A)_axis.
    Every ordered shell pair of a class at once, every center in one
    Hermite recursion, the weights folded in before the contraction."""
    centers = np.asarray(centers, dtype=np.float64).reshape(-1, 3)
    weights = np.asarray(weights, dtype=np.float64).reshape(-1)
    ncen = centers.shape[0]
    nao = layout.nao
    out = np.zeros((len(ops), nao, nao))
    L_extra = max((bra is not None) + (ket is not None) for bra, ket in ops)

    def per_prim(la, lb):
        return _nherm(la + lb + L_extra) * (ncen + len(ops) * _ncart(la) * _ncart(lb))

    for bt in _batches(layout, False, per_prim):
        la, lb = bt.la, bt.lb
        E = bt.e_tensors(1)
        p = bt.p
        P = (bt.a[:, None] * bt.A + bt.b[:, None] * bt.B) / p[:, None]
        PC = (P[None, :, :] - centers[:, None, :]).reshape(-1, 3)
        Rw = {}
        blk = np.empty((len(ops), _ncart(la) * _ncart(lb), len(p)))
        for k, (bra, ket) in enumerate(ops):
            L = la + lb + (bra is not None) + (ket is not None)
            if L not in Rw:
                R = md.hermite_coulomb(L, np.tile(p, ncen), PC).reshape(-1, ncen, len(p))
                Rw[L] = np.einsum("hkp,k->hp", R, weights) * (2.0 * np.pi / p)
            D = [_deriv_table(E[d], la, lb, bt.a, bt.b,
                              bra[0] if bra is not None and bra[1] == d else None,
                              ket[0] if ket is not None and ket[1] == d else None, L + 1)
                 for d in range(3)]
            blk[k] = np.einsum("chp,hp->cp", _hermite(D, la, lb, L) * bt.cc, Rw[L])
            if moment_origin is not None and bra is not None and bra[0] == "m":
                # (r - G) = (r - A) + (A - G): the pair without the moment
                k0 = ops.index((None, ket))
                blk[k] += (bt.A[:, bra[1]] - moment_origin[bra[1]]) * blk[k0]
        sums = np.add.reduceat(blk, bt.bounds[:-1], axis=-1)
        m = sums.reshape(len(ops), _ncart(la), _ncart(lb), -1)
        sph = np.einsum("xabP,ai,bj->xPij", m, cart2sph(la), cart2sph(lb))
        ia = _pair_rows(bt.pairs, 2, la)
        ib = _pair_rows(bt.pairs, 3, lb)
        out[:, ia[:, :, None], ib[:, None, :]] = sph
    return out


_DD = [(("d", i), ("d", j)) for i in range(3) for j in range(3)]


def _rinv_deriv2_sum(layout: BasisLayout, centers, weights) -> np.ndarray:
    """(3, 3, nao, nao) sum_C w_C <d_i mu | 1/|r-C| | d_j nu>."""
    return _nuclear_sum(layout, centers, weights, _DD).reshape(3, 3, layout.nao, layout.nao)


def rinv_deriv2(layout: BasisLayout, center) -> np.ndarray:
    """(3, 3, nao, nao) tensor <d_i mu | 1/|r-C| | d_j nu> (positive kernel)."""
    return _rinv_deriv2_sum(layout, [center], [1.0])


def nuclear_deriv2(layout: BasisLayout):
    """(w_sf, w_so): the spin-free W = p.Vnuc.p (nao, nao) and the spin-orbit
    vector Wso (3, nao, nao), Vnuc = -sum_A Z_A / r_A, from one pass over the
    shell-pair classes with every nucleus at once."""
    mol = layout.mol
    W = _rinv_deriv2_sum(layout, mol.coords, -np.asarray(mol.charges, dtype=np.float64))
    return W[0, 0] + W[1, 1] + W[2, 2], np.einsum("lmn,mnpq->lpq", _EPS, W)


def pnucp(layout: BasisLayout) -> np.ndarray:
    """Spin-free W = p . Vnuc . p = sum_d <d_d mu| Vnuc |d_d nu>
    (Vnuc = -sum_A Z_A / r_A); symmetric (int1e_pnucp)."""
    return nuclear_deriv2(layout)[0]


def wso(layout: BasisLayout) -> np.ndarray:
    """One-electron spin-orbit vector integrals
    Wso_l = eps_{lmn} <d_m mu| Vnuc |d_n nu>  (antisymmetric per component),
    the reference's `get_wso` = -sum_A Z_A * cint1e_prinvxp
    (`sfX2C_soDKH1.py:202-216`)."""
    return nuclear_deriv2(layout)[1]


# -- the Hermite-Coulomb tensor in torch -------------------------------------

def _boys_t(mmax: int, x: torch.Tensor) -> torch.Tensor:
    """Boys function F_m(x), m = 0..mmax, (mmax+1, N): `mcmurchie.boys` in
    torch (the regularized incomplete gamma, then downward recursion)."""
    small = x < 1e-13
    xs = torch.where(small, torch.ones_like(x), x)
    a = mmax + 0.5
    fm = (math.exp(math.lgamma(a)) * torch.special.gammainc(torch.full_like(xs, a), xs)
          / (2.0 * xs ** a))
    fm = torch.where(small, 1.0 / (2 * mmax + 1) - x / (2 * mmax + 3), fm)
    out = [fm]
    ex = torch.exp(-x)
    for m in range(mmax, 0, -1):
        fm = (2.0 * x * fm + ex) / (2 * m - 1)
        fm = torch.where(small, 1.0 / (2 * m - 1) - x / (2 * m + 1), fm)
        out.append(fm)
    return torch.stack(out[::-1])


@lru_cache(maxsize=None)
def _herm_recursion(L: int):
    """For each Hermite index (t, u, v) of order <= L in `herm_indices`
    order: the axis its recursion steps down, the indices of the two terms
    it reads (one and two steps down that axis) and the second term's
    factor, as `mcmurchie.hermite_coulomb` chooses them."""
    hidx = herm_indices(L)
    pos = herm_index_map(L)
    axis = np.zeros(len(hidx), dtype=np.int64)
    prev = np.zeros(len(hidx), dtype=np.int64)
    prev2 = np.zeros(len(hidx), dtype=np.int64)
    coef = np.zeros(len(hidx))
    for h, tuv in enumerate(hidx):
        if h == 0:
            continue
        d = 0 if tuv[0] > 0 else (1 if tuv[1] > 0 else 2)
        down = list(tuv)
        down[d] -= 1
        axis[h], prev[h] = d, pos[tuple(down)]
        if tuv[d] > 1:
            down[d] -= 1
            prev2[h], coef[h] = pos[tuple(down)], tuv[d] - 1
    return axis, prev, prev2, coef


def hermite_coulomb_t(L: int, p: torch.Tensor, PC: torch.Tensor, omega: float = 0.0,
                      boys=_boys_t) -> torch.Tensor:
    """R^0_{tuv}(p, PC) for all t+u+v <= L, (nherm(L), N): the recursion of
    `mcmurchie.hermite_coulomb`, one vectorized step per order.  The
    indices of order <= L - m are a prefix of `herm_indices(L)`, so order m
    is a gather from order m + 1.  ``omega`` > 0 attenuates the kernel to
    erf(omega r)/r: F_m(T) -> s^(m+1/2) F_m(s T), s = omega^2 / (omega^2 +
    p).  ``boys``: the Boys function, (mmax, x) -> (mmax+1, N)."""
    T = p * torch.sum(PC * PC, dim=1)
    if omega and omega > 0.0:
        s = omega * omega / (omega * omega + p)
        n = torch.arange(L + 1, dtype=p.dtype, device=p.device)[:, None]
        F = boys(L, s * T) * s[None, :] ** (n + 0.5)
    else:
        F = boys(L, T)
    axis, prev, prev2, coef = (torch.as_tensor(v, device=p.device)
                               for v in _herm_recursion(L))
    coef = coef.to(p.dtype)
    R = ((-2.0 * p) ** L * F[L])[None]
    for m in range(L - 1, -1, -1):
        n = _nherm(L - m)
        rest = (PC[:, axis[1:n]].T * R[prev[1:n]]
                + coef[1:n, None] * R[prev2[1:n]])
        R = torch.cat([((-2.0 * p) ** m * F[m])[None], rest])
    return R


# -- two-electron: eps_lij (d_i mu nu | d_j ka la) ---------------------------

@dataclasses.dataclass
class _PairClass:
    """The bra-derivative pairs of one class (la, lb) on the device: the
    three derivatives' Hermite expansions (nprim, 3 * ncab, nherm(la+lb+1)),
    the same with the ket sign (-1)^(t+u+v), exponent sums p and centers P
    of each primitive pair, where each pair's primitives start, and the AO
    rows of its two shells."""
    la: int
    lb: int
    H: torch.Tensor
    Hs: torch.Tensor
    p: torch.Tensor
    P: torch.Tensor
    bounds: np.ndarray
    rows_a: np.ndarray
    rows_b: np.ndarray

    @property
    def L(self) -> int:
        return self.la + self.lb + 1

    @property
    def ncab(self) -> int:
        return _ncart(self.la) * _ncart(self.lb)


def _deriv_pair_class(la, lb, pairs, device, dtype) -> _PairClass:
    bt = _make_batch(la, lb, pairs)
    E = bt.e_tensors(1)
    L = la + lb + 1
    H = np.stack([
        _hermite([_deriv_table(E[dd], la, lb, bt.a, bt.b, "d" if dd == d else None, None, L + 1)
                  for dd in range(3)], la, lb, L) * bt.cc
        for d in range(3)])  # (3, ncab, nherm, nprim)
    H = np.ascontiguousarray(H.transpose(3, 0, 1, 2).reshape(len(bt.a), -1, _nherm(L)))
    P = (bt.a[:, None] * bt.A + bt.b[:, None] * bt.B) / bt.p[:, None]

    def dev(x):
        return torch.as_tensor(x, device=device, dtype=dtype)

    return _PairClass(la=la, lb=lb, H=dev(H), Hs=dev(H * _herm_sign(L)[None, None, :]),
                      p=dev(bt.p), P=dev(P), bounds=bt.bounds,
                      rows_a=_pair_rows(pairs, 2, la), rows_b=_pair_rows(pairs, 3, lb))


@dataclasses.dataclass
class QuartetChunk:
    """Spherical SO blocks of some shell quartets of one class:
    ``t[q, l] = K_l[a, b, c, d]`` (nq, 3, na, nb, nc, nd), the AO indices
    ``ia`` (nq, na) ... ``id`` (nq, nd) of each quartet's four shells, and
    ``mirror`` (nq,) true where the bra and ket pairs differ, whose
    quartet-swap mirror K[cd, ab] = -K[ab, cd] is a block of its own."""
    t: torch.Tensor
    ia: np.ndarray
    ib: np.ndarray
    ic: np.ndarray
    id: np.ndarray
    mirror: np.ndarray


def _quartets(layout: BasisLayout, use_1c: bool):
    """The JAX package's ordered shell-pair list and its quartets
    (ip >= kp; with ``use_1c`` all four shells on one atom), as arrays."""
    shells = layout.shells
    nsh = len(shells)
    atoms = np.array([sh.atom_index for sh in shells])
    i, j = np.divmod(np.arange(nsh * nsh), nsh)
    if use_1c:
        keep = atoms[i] == atoms[j]
        i, j = i[keep], j[keep]
    pair_atom = atoms[i]
    ip, kp = [], []
    groups = np.unique(pair_atom) if use_1c else [None]
    for a in groups:
        idx = np.flatnonzero(pair_atom == a) if use_1c else np.arange(len(i))
        r, c = np.tril_indices(len(idx))
        ip.append(idx[r])
        kp.append(idx[c])
    return i, j, np.concatenate(ip), np.concatenate(kp)


def kint_class_blocks(layout: BasisLayout, use_1c: bool = False, device=None,
                      dtype=torch.float64):
    """Chunks (`QuartetChunk`) of the SO two-electron tensor, every shell
    quartet of the JAX package's `kint_blocks` once, a class at a time:
    the Hermite-Coulomb tensor of the whole chunk in one recursion and both
    contractions with the derivative pairs as batched matrix products, on
    ``device`` (default: the card)."""
    device, _ = config.resolve(device)
    shells = layout.shells
    pi, pj, ip, kp = _quartets(layout, use_1c)
    pl = np.array([shells[a].l for a in pi])
    ql = np.array([shells[b].l for b in pj])
    ccls = pl * 5 + ql
    classes: dict[int, _PairClass] = {}
    pos = np.zeros(len(pi), dtype=np.int64)  # each pair's index in its class
    for c in np.unique(ccls):
        members = np.flatnonzero(ccls == c)
        pos[members] = np.arange(len(members))
        la, lb = divmod(int(c), 5)
        classes[int(c)] = _deriv_pair_class(
            la, lb, [(pi[m], pj[m], shells[pi[m]], shells[pj[m]]) for m in members],
            device, dtype)
    eps = torch.as_tensor(_EPS, device=device, dtype=dtype)
    qkey = ccls[ip] * 25 + ccls[kp]
    order = np.argsort(qkey, kind="stable")
    cuts = np.flatnonzero(np.diff(qkey[order])) + 1
    for seg in np.split(order, cuts):
        bra = classes[int(ccls[ip[seg[0]]])]
        ket = classes[int(ccls[kp[seg[0]]])]
        nhb, nhk = _nherm(bra.L), _nherm(ket.L)
        nb_prim = np.diff(bra.bounds)[pos[ip[seg]]]
        nk_prim = np.diff(ket.bounds)[pos[kp[seg]]]
        per_q = int(np.max(nb_prim * nk_prim)) * max(
            nhb * nhk, 3 * bra.ncab * nhk, 9 * bra.ncab * ket.ncab)
        step = max(1, _QUARTET_ELEMS // per_q)
        for s0 in range(0, len(seg), step):
            q = seg[s0:s0 + step]
            yield _class_chunk(bra, ket, pos[ip[q]], pos[kp[q]], ip[q] != kp[q], eps)


def _class_chunk(bra: _PairClass, ket: _PairClass, bpos, kpos, mirror, eps) -> QuartetChunk:
    device, dtype = bra.H.device, bra.H.dtype
    nq = len(bpos)
    nb_prim = np.diff(bra.bounds)[bpos]
    nk_prim = np.diff(ket.bounds)[kpos]
    counts = nb_prim * nk_prim
    if np.all(counts == 1):
        q_of = None
        bprim = bra.bounds[bpos]
        kprim = ket.bounds[kpos]
    else:
        # every primitive quartet of the chunk, summed per quartet below
        q_of = np.repeat(np.arange(nq), counts)
        r = np.arange(q_of.size) - np.repeat(np.cumsum(counts) - counts, counts)
        bprim = bra.bounds[bpos][q_of] + r // nk_prim[q_of]
        kprim = ket.bounds[kpos][q_of] + r % nk_prim[q_of]
    bprim = torch.as_tensor(bprim, device=device)
    kprim = torch.as_tensor(kprim, device=device)
    pb, pk = bra.p[bprim], ket.p[kprim]
    pq = pb * pk
    psum = pb + pk
    L = bra.L + ket.L
    R = hermite_coulomb_t(L, pq / psum, bra.P[bprim] - ket.P[kprim])
    R = R * (2.0 * math.pi ** 2.5 / (pq * torch.sqrt(psum)))[None, :]
    cidx = torch.as_tensor(_comb_index(bra.L, ket.L).reshape(-1), device=device)
    R4 = R[cidx].reshape(_nherm(bra.L), _nherm(ket.L), -1).permute(2, 0, 1)
    # all nine derivative combinations in two batched products
    Y = torch.bmm(torch.bmm(bra.H[bprim], R4), ket.Hs[kprim].transpose(1, 2))
    if q_of is not None:
        Y = torch.zeros((nq,) + Y.shape[1:], device=device, dtype=dtype).index_add_(
            0, torch.as_tensor(q_of, device=device), Y)
    Y = Y.reshape(nq, 3, bra.ncab, 3, ket.ncab)
    so = torch.einsum("lde,qdaeb->qlab", eps, Y)
    t = so.reshape(nq, 3, _ncart(bra.la), _ncart(bra.lb), _ncart(ket.la), _ncart(ket.lb))
    for ax, l in zip(range(2, 6), (bra.la, bra.lb, ket.la, ket.lb)):
        C = torch.as_tensor(cart2sph(l), device=device, dtype=dtype)
        t = torch.tensordot(t, C, dims=([ax], [0])).movedim(-1, ax)
    return QuartetChunk(t=t, ia=bra.rows_a[bpos], ib=bra.rows_b[bpos], ic=ket.rows_a[kpos],
                        id=ket.rows_b[kpos], mirror=np.asarray(mirror))


def kint_blocks(layout: BasisLayout, use_1c: bool = False, device=None):
    """Spherical shell-quartet blocks of the SO 2e tensor, as the JAX
    package's generator yields them: ``(sl_a, sl_b, sl_c, sl_d, t)`` with
    ``t`` (3, nA, nB, nC, nD) = K_l[A, B, C, D] (host numpy), each unordered
    (bra-pair, ket-pair) combination once and its quartet-swap mirror
    K[cd, ab] = -K[ab, cd] as a second block.  The order is by class, not
    the JAX package's pair order.  The chunks are computed on ``device``
    (default: the card)."""
    for ch in kint_class_blocks(layout, use_1c=use_1c, device=device):
        t = ch.t.cpu().numpy()
        for q in range(t.shape[0]):
            sa, sb, sc, sd = (slice(int(r[q, 0]), int(r[q, -1]) + 1)
                              for r in (ch.ia, ch.ib, ch.ic, ch.id))
            yield sa, sb, sc, sd, t[q]
            if ch.mirror[q]:
                yield sc, sd, sa, sb, -np.transpose(t[q], (0, 3, 4, 1, 2))


def kint(layout: BasisLayout, use_1c: bool = False, device=None) -> np.ndarray:
    """SO two-electron tensor K_l[mu,nu,ka,la] = eps_{lij}
    (d_i mu nu | d_j ka la), chemists' notation (`sfX2C_soDKH1.py:218-243`),
    3 nao^4 doubles on the host.  With ``use_1c`` only AO quartets whose
    four shells share one atom are evaluated (the one-center approximation,
    `get_fso2e_1c`:294).  The chunks are computed on ``device`` (default:
    the card)."""
    nao = layout.nao
    out = np.zeros((3, nao, nao, nao, nao))
    for ch in kint_class_blocks(layout, use_1c=use_1c, device=device):
        t = ch.t.cpu().numpy()
        ia, ib, ic, id_ = (r[:, :, None, None, None] for r in (ch.ia, ch.ib, ch.ic, ch.id))
        out[:, ia, ib.transpose(0, 2, 1, 3, 4), ic.transpose(0, 2, 3, 1, 4),
            id_.transpose(0, 2, 3, 4, 1)] = t.transpose(1, 0, 2, 3, 4, 5)
        m = ch.mirror
        out[:, ic[m], id_[m].transpose(0, 2, 1, 3, 4), ia[m].transpose(0, 2, 3, 1, 4),
            ib[m].transpose(0, 2, 3, 4, 1)] = -t[m].transpose(1, 0, 4, 5, 2, 3)
    return out


__all__ = ["rinv_deriv2", "nuclear_deriv2", "pnucp", "wso", "kint_class_blocks",
           "kint_blocks", "kint", "hermite_coulomb_t", "QuartetChunk"]

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

import dataclasses

import numpy as np

from xtddft_tpu_torch.ints import mcmurchie as md
from xtddft_tpu_torch.ints.shell import BasisLayout, Shell, cart2sph, cart_components


def _pair_weight(p: np.ndarray, cc: np.ndarray) -> np.ndarray:
    return cc * (np.pi / p) ** 1.5


def _components(la: int, lb: int):
    """Cartesian exponents of the two shells' components as (nca, 1, 3) and
    (1, ncb, 3) arrays: indexing a 1-D E tensor with their d-th columns
    gives every component pair at once, (nca, ncb, ...)."""
    ca = np.asarray(cart_components(la))[:, None, :]
    cb = np.asarray(cart_components(lb))[None, :, :]
    return ca, cb


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


# -- batched assembly -------------------------------------------------------
#
# The primitive-pair integrands of every shell pair of one angular-momentum
# class (la, lb) are computed at once over the class's primitive pairs, laid
# end to end; a loop over shell pairs doing that costs ~1 ms of Python per
# pair, and TTM/dzp has 27,000 of them (54,000 ordered ones).  Each shell
# pair then sums its own primitives and turns spherical exactly as the
# per-pair code did (the same pairwise sums and matrix products), so the
# integrals are bitwise those of the JAX package's engine: the SCF's choice
# between near-degenerate states (the half-filled pi pair of FH or OH on a
# coarse grid) follows the last bit of its guess.

_BATCH_ELEMS = 1 << 23  # (component pairs x primitive pairs) per batch


@dataclasses.dataclass
class _Batch:
    """The primitive pairs of some shell pairs of one class (la, lb): their
    exponents a, b, contraction products cc and centers A, B (one row per
    primitive pair), and where each shell pair's primitives start and end."""
    la: int
    lb: int
    pairs: list  # (index a, index b, shell a, shell b)
    a: np.ndarray
    b: np.ndarray
    cc: np.ndarray
    A: np.ndarray
    B: np.ndarray
    bounds: np.ndarray  # (npairs + 1,)

    @property
    def p(self) -> np.ndarray:
        return self.a + self.b

    def e_tensors(self, ldelta: int):
        """E^{ij}_t per dimension, (la+ld+1, lb+ld+1, la+lb+2ld+1, nprim)."""
        AB = self.A - self.B
        return [md.e_coeffs_1d(self.la + ldelta, self.lb + ldelta, self.a, self.b, AB[:, d])
                for d in range(3)]

    def spans(self):
        """(pair, its primitives' slice) for every shell pair."""
        for k, pr in enumerate(self.pairs):
            yield pr, slice(self.bounds[k], self.bounds[k + 1])


def _make_batch(la: int, lb: int, pairs: list) -> _Batch:
    counts = [len(sa.exps) * len(sb.exps) for _, _, sa, sb in pairs]
    return _Batch(
        la=la, lb=lb, pairs=pairs,
        a=np.concatenate([np.repeat(sa.exps, len(sb.exps)) for _, _, sa, sb in pairs]),
        b=np.concatenate([np.tile(sb.exps, len(sa.exps)) for _, _, sa, sb in pairs]),
        cc=np.concatenate([np.repeat(sa.coefs, len(sb.coefs)) * np.tile(sb.coefs, len(sa.coefs))
                           for _, _, sa, sb in pairs]),
        A=np.repeat(np.stack([sa.center for _, _, sa, _ in pairs]), counts, axis=0),
        B=np.repeat(np.stack([sb.center for _, _, _, sb in pairs]), counts, axis=0),
        bounds=np.concatenate([[0], np.cumsum(counts)]).astype(np.intp))


def _batches(layout: BasisLayout, hermitian: bool, per_prim):
    """Batches of shell pairs (b <= a when ``hermitian``), one class each,
    of at most ``_BATCH_ELEMS / per_prim(la, lb)`` primitive pairs."""
    shells = layout.shells
    groups: dict[tuple[int, int], list] = {}
    for i, sa in enumerate(shells):
        for j in range(i + 1 if hermitian else len(shells)):
            groups.setdefault((sa.l, shells[j].l), []).append((i, j, sa, shells[j]))
    for (la, lb), pairs in groups.items():
        most = max(1, _BATCH_ELEMS // per_prim(la, lb))
        chunk, n = [], 0
        for pr in pairs:
            k = len(pr[2].exps) * len(pr[3].exps)
            if chunk and n + k > most:
                yield _make_batch(la, lb, chunk)
                chunk, n = [], 0
            chunk.append(pr)
            n += k
        if chunk:
            yield _make_batch(la, lb, chunk)


def _ncart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def _put(out, i, j, sa, sb, blk, hermitian):
    """Scatter one shell pair's (ncomp, na, nb) block (and its mirror)."""
    ra = slice(sa.ao_offset, sa.ao_offset + sa.nao)
    rb = slice(sb.ao_offset, sb.ao_offset + sb.nao)
    out[:, ra, rb] = blk
    if hermitian and i != j:
        out[:, rb, ra] = np.transpose(blk, (0, 2, 1))


def _assemble_batched(layout: BasisLayout, integrand, ncomp: int = 1, hermitian: bool = True):
    """integrand(batch) -> (ncomp, nca, ncb, nprim): the Cartesian
    integrands of every primitive pair of the batch, weights and
    contraction included; summed per shell pair, made spherical and
    scattered into (ncomp, nao, nao) (the lower triangle mirrored when
    ``hermitian``)."""
    nao = layout.nao
    out = np.zeros((ncomp, nao, nao))
    for bt in _batches(layout, hermitian, lambda la, lb: 8 * _ncart(la) * _ncart(lb)):
        vals = integrand(bt)
        for (i, j, sa, sb), span in bt.spans():
            m = np.sum(vals[..., span], axis=-1)
            _put(out, i, j, sa, sb, np.stack([_sph_block(m[c], bt.la, bt.lb)
                                              for c in range(ncomp)]), hermitian)
    return out[0] if ncomp == 1 else out


def _s(E, ci, cj, d, di=0, dj=0):
    """E^{i+di, j+dj}_0 along dimension d for every component pair,
    (nca, ncb, nprim); a negative index (the i - 1 term at i = 0) reads
    index 0, whose factor i is zero."""
    return E[d][np.maximum(ci[..., d] + di, 0), np.maximum(cj[..., d] + dj, 0), 0]


# -- overlap / kinetic ------------------------------------------------------

def overlap(layout: BasisLayout) -> np.ndarray:
    def integrand(bt):
        E = bt.e_tensors(0)
        ci, cj = _components(bt.la, bt.lb)
        w = _pair_weight(bt.p, bt.cc)
        return (w * _s(E, ci, cj, 0) * _s(E, ci, cj, 1) * _s(E, ci, cj, 2))[None]

    return _assemble_batched(layout, integrand)


def kinetic(layout: BasisLayout) -> np.ndarray:
    def integrand(bt):
        E = bt.e_tensors(2)
        ci, cj = _components(bt.la, bt.lb)
        w = _pair_weight(bt.p, bt.cc)
        b = bt.b

        def t1(d):
            jf = cj[..., d, None]
            # the j - 2 term's factor is zero for j < 2
            return (b * (2 * jf + 1) * _s(E, ci, cj, d) - 2.0 * b**2 * _s(E, ci, cj, d, dj=2)
                    - 0.5 * jf * (jf - 1) * _s(E, ci, cj, d, dj=-2))

        sx, sy, sz = (_s(E, ci, cj, d) for d in range(3))
        tx, ty, tz = (t1(d) for d in range(3))
        return (w * (tx * sy * sz + sx * ty * sz + sx * sy * tz))[None]

    return _assemble_batched(layout, integrand)


# -- nuclear attraction -----------------------------------------------------

def nuclear_attraction(layout: BasisLayout) -> np.ndarray:
    mol = layout.mol
    charges = mol.charges
    centers = np.asarray(mol.coords)
    natm = len(charges)

    def per_prim(la, lb):
        L = la + lb
        return (L + 1) * (L + 2) * (L + 3) // 6 * (_ncart(la) * _ncart(lb) + 2 * natm)

    out = np.zeros((1, layout.nao, layout.nao))
    for bt in _batches(layout, True, per_prim):
        E = bt.e_tensors(0)
        ci, cj = _components(bt.la, bt.lb)
        p = bt.p
        P = (bt.a[:, None] * bt.A + bt.b[:, None] * bt.B) / p[:, None]
        L = bt.la + bt.lb
        h = np.asarray(md.herm_indices(L))
        # the Hermite expansion of each component pair, (nca * ncb, nherm,
        # nprim), rows a-major (the component pairs of `make_shell_pair`)
        H = (E[0][ci[..., 0, None], cj[..., 0, None], h[:, 0]]
             * E[1][ci[..., 1, None], cj[..., 1, None], h[:, 1]]
             * E[2][ci[..., 2, None], cj[..., 2, None], h[:, 2]]).reshape(-1, len(h), len(p))
        H = H * bt.cc[None, None, :]
        # every nucleus in one Hermite recursion over (nucleus, primitive pair)
        PC = (P[None, :, :] - centers[:, None, :]).reshape(-1, 3)
        R = md.hermite_coulomb(L, np.tile(p, natm), PC).reshape(len(h), natm, len(p))
        R = np.ascontiguousarray(R.transpose(1, 0, 2))  # (nucleus, nherm, nprim)
        pref = 2.0 * np.pi / p
        for (i, j, sa, sb), span in bt.spans():
            # each nucleus's term as the per-pair code summed it (one einsum
            # over the nuclei gives the same sums), accumulated nucleus by
            # nucleus in its order
            terms = np.einsum("chp,khp,p->kc", np.ascontiguousarray(H[:, :, span]),
                              np.ascontiguousarray(R[:, :, span]), pref[span])
            total = np.zeros(terms.shape[1])
            for Z, t in zip(charges, terms):
                total = total - Z * t
            _put(out, i, j, sa, sb, _sph_block(total, bt.la, bt.lb)[None], True)
    return out[0]


# -- moments ----------------------------------------------------------------

def dipole(layout: BasisLayout, origin=(0.0, 0.0, 0.0)) -> np.ndarray:
    """<mu|(r - origin)|nu>, shape (3, nao, nao), symmetric per component."""
    origin = np.asarray(origin, dtype=np.float64)

    def integrand(bt):
        E = bt.e_tensors(1)
        ci, cj = _components(bt.la, bt.lb)
        w = _pair_weight(bt.p, bt.cc)
        BC = bt.B - origin
        s = [_s(E, ci, cj, d) for d in range(3)]
        m = [_s(E, ci, cj, d, dj=1) + BC[:, d] * s[d] for d in range(3)]
        return np.stack([w * m[0] * s[1] * s[2], w * s[0] * m[1] * s[2],
                         w * s[0] * s[1] * m[2]])

    return _assemble_batched(layout, integrand, ncomp=3)


# -- derivative integrals ---------------------------------------------------

def ip_overlap(layout: BasisLayout) -> np.ndarray:
    """<d/dr mu | nu>, shape (3, nao, nao); antisymmetric overall."""

    def integrand(bt):
        E = bt.e_tensors(1)
        ci, cj = _components(bt.la, bt.lb)
        w = _pair_weight(bt.p, bt.cc)
        s = [_s(E, ci, cj, d) for d in range(3)]
        # the i - 1 term's factor i is zero for i = 0
        dv = [-2.0 * bt.a * _s(E, ci, cj, d, di=1) + ci[..., d, None] * _s(E, ci, cj, d, di=-1)
              for d in range(3)]
        return np.stack([w * dv[0] * s[1] * s[2], w * s[0] * dv[1] * s[2],
                         w * s[0] * s[1] * dv[2]])

    return _assemble_batched(layout, integrand, ncomp=3, hermitian=False)


def angular_momentum(layout: BasisLayout, gauge_origin=(0.0, 0.0, 0.0)) -> np.ndarray:
    """<mu| (r-G) x nabla |nu> (real, antisymmetric), shape (3, nao, nao)."""
    G = np.asarray(gauge_origin, dtype=np.float64)

    def integrand(bt):
        E = bt.e_tensors(1)
        ci, cj = _components(bt.la, bt.lb)
        w = _pair_weight(bt.p, bt.cc)
        BG = bt.B - G
        s = [_s(E, ci, cj, d) for d in range(3)]
        # ket moment (r_d - G_d) and ket derivative d/d r_d (the j - 1
        # term's factor j is zero for j = 0)
        mom = [_s(E, ci, cj, d, dj=1) + BG[:, d] * s[d] for d in range(3)]
        der = [-2.0 * bt.b * _s(E, ci, cj, d, dj=1) + cj[..., d, None] * _s(E, ci, cj, d, dj=-1)
               for d in range(3)]
        # L_x = y dz - z dy ; L_y = z dx - x dz ; L_z = x dy - y dx
        return np.stack([w * s[0] * (mom[1] * der[2] - mom[2] * der[1]),
                         w * s[1] * (mom[2] * der[0] - mom[0] * der[2]),
                         w * s[2] * (mom[0] * der[1] - mom[1] * der[0])])

    return _assemble_batched(layout, integrand, ncomp=3, hermitian=False)


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

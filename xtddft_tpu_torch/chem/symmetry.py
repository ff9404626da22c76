"""Abelian point-group detection and irrep labeling (D2h and subgroups).

Host numpy; a copy of the JAX package's `chem/symmetry.py` (which imports no
JAX), kept in the port so that it never loads the JAX package.  PySCF labels
excited states with point-group irreps through ``symm.direct_prod`` over
``mol.irrep_id``; this module provides the same capability from scratch:

1.  **Detection** happens in the charge-weighted principal-axes frame,
    where every candidate operation of D2h and its subgroups is an axis
    sign flip ``diag(sx, sy, sz)``.  The subset of the eight sign
    vectors that maps the nuclear frame onto itself (as a same-element
    permutation) is automatically a subgroup of (Z2)^3 and identifies
    the abelian point group: D2h, D2, C2v, C2h, C2, Cs, Ci, or C1.
    Linear molecules resolve to the C2v/D2h subgroup of C-inf-v/D-inf-h
    (PySCF supports the full axial groups; the abelian subgroup labels
    carry the same g/u and sigma/pi information for the states the
    methods compute).  For symmetric tops whose degenerate principal
    axes hide a mirror plane, the frame is re-tried with each off-axis
    atom rotated into the xz plane.

2.  **MO characters** are exact matrix elements: each operation maps
    back to the original frame as O = R diag(s) R^T, the AO
    representation is (atom permutation) x D^l(O) with the real-solid-
    harmonic rotation blocks D^l derived *numerically* from the
    monomial transformation and the cart->sph patterns of `ints/shell.py`
    (no tabulated Wigner matrices), and chi_i = c_i^T S_rep c_i = +-1.

3.  **State irreps** are direct products chi_occ * chi_vir of the
    dominant amplitude, exactly the reference's ``direct_prod`` logic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from xtddft_tpu_torch.ints.shell import (
    BasisLayout,
    _angular_overlap,
    cart2sph,
    cart_components,
    double_factorial,
)

__all__ = ["SymmetryInfo", "analyze", "mo_irreps", "product_label"]

# the eight candidate operations, as sign vectors in the principal frame
_SIGNS = [
    (1, 1, 1), (-1, -1, 1), (-1, 1, -1), (1, -1, -1),
    (-1, -1, -1), (1, 1, -1), (1, -1, 1), (-1, 1, 1),
]
_NAMES = ["E", "C2z", "C2y", "C2x", "i", "sxy", "sxz", "syz"]


def _op_name(s) -> str:
    return _NAMES[_SIGNS.index(tuple(int(x) for x in s))]


# ---------------------------------------------------------------------------
# geometric detection
# ---------------------------------------------------------------------------


def _charge_frame(coords, charges):
    """(centroid, principal rotation R): rows of R^T are the axes."""
    c = (charges[:, None] * coords).sum(0) / charges.sum()
    X = coords - c
    r2 = (X * X).sum(axis=1)
    I = np.einsum("a,ai,aj->ij", charges, X, X)
    I = np.eye(3) * float(charges @ r2) - I
    w, R = np.linalg.eigh(I)
    # deterministic axis orientation (sign fix: largest component positive)
    for k in range(3):
        j = np.argmax(np.abs(R[:, k]))
        if R[j, k] < 0:
            R[:, k] = -R[:, k]
    if np.linalg.det(R) < 0:
        R[:, 2] = -R[:, 2]
    return c, R


def _match_permutation(X, Y, symbols, tol):
    """perm with Y[i] ~= X[perm[i]] and matching elements, or None."""
    n = len(symbols)
    perm = np.full(n, -1, dtype=int)
    used = np.zeros(n, dtype=bool)
    for i in range(n):
        d = np.linalg.norm(X - Y[i], axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        if d[j] > tol or symbols[j] != symbols[i]:
            return None
        perm[i] = j
        used[j] = True
    return perm


def _find_ops(X, symbols, tol):
    """[(sign_vector, perm)] for all candidate ops that hold."""
    out = []
    for s in _SIGNS:
        perm = _match_permutation(X, X * np.asarray(s, dtype=float), symbols,
                                  tol)
        if perm is not None:
            out.append((s, perm))
    return out


def _group_name(signs) -> str:
    signs = {tuple(s) for s in signs}
    n = len(signs)
    has_i = (-1, -1, -1) in signs
    n_c2 = sum(1 for s in signs if sum(s) == -1)   # two sign flips
    n_sig = sum(1 for s in signs if sum(s) == 1 and s != (1, 1, 1))
    if n == 8:
        return "D2h"
    if n == 4:
        if has_i:
            return "C2h"
        return "D2" if n_c2 == 3 else "C2v"
    if n == 2:
        if has_i:
            return "Ci"
        return "Cs" if n_sig else "C2"
    return "C1"


@dataclasses.dataclass
class SymmetryInfo:
    group: str
    centroid: np.ndarray          # original frame
    R: np.ndarray                 # principal rotation (columns = axes)
    ops: list                     # [(name, sign_vector, O_orig(3,3), perm)]
    tol: float

    @property
    def op_names(self):
        return [o[0] for o in self.ops]


def _canonical_axes(R, ops, Xc, charges) -> np.ndarray:
    """Permute the principal axes into chemistry convention: the unique
    C2 axis (C2/C2v/C2h) — or, for D2/D2h, the C2 with the smallest
    moment of inertia (the molecular axis of linear molecules) — goes to
    z; if the molecule is planar, the plane becomes xz."""
    signs = [s for s, _ in ops]
    c2s = [s for s in signs if sum(s) == -1]
    X = Xc @ R
    mom = np.array([charges @ (X[:, [1, 2]] ** 2).sum(1),
                    charges @ (X[:, [0, 2]] ** 2).sum(1),
                    charges @ (X[:, [0, 1]] ** 2).sum(1)])

    def axis_of(s):
        return int(np.argmax(s))  # the +1 entry of a C2 sign vector

    if len(c2s) == 1:
        zax = axis_of(c2s[0])
    elif len(c2s) == 3:
        zax = int(np.argmin([mom[axis_of(s)] for s in c2s]))
        zax = axis_of(c2s[zax])
    else:
        return R
    rest = [k for k in range(3) if k != zax]
    # planar molecule: in-plane axis -> x (plane = xz)
    spread = np.array([np.abs(X[:, k]).max() for k in range(3)])
    if spread[rest[0]] < spread[rest[1]]:
        rest = [rest[1], rest[0]]
    perm = [rest[0], rest[1], zax]
    P = np.zeros((3, 3))
    for new, old in enumerate(perm):
        P[old, new] = 1.0
    if np.linalg.det(P) < 0:
        P[:, 1] = -P[:, 1]
    return R @ P


def _rot_about(axis: int, theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    if axis == 2:
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    raise ValueError(axis)


def analyze(mol, tol: float = 1e-4) -> SymmetryInfo:
    """Detect the abelian point group of a molecule (coords in bohr)."""
    coords = np.asarray(mol.coords, dtype=np.float64)
    charges = np.asarray(mol.charges, dtype=np.float64)
    symbols = list(mol.symbols)
    c, R0 = _charge_frame(coords, charges)

    best = None
    frames = [R0]
    # degenerate-axis retries: rotate each off-axis atom into the xz plane
    X0 = (coords - c) @ R0
    for x in X0:
        rho = np.hypot(x[0], x[1])
        if rho > tol * 10:
            th = np.arctan2(x[1], x[0])
            frames.append(R0 @ _rot_about(2, th))
    for R in frames:
        X = (coords - c) @ R
        ops = _find_ops(X, symbols, tol)
        if best is None or len(ops) > len(best[1]):
            best = (R, ops)
        if len(ops) == 8:
            break
    R, ops = best
    R = _canonical_axes(R, ops, coords - c, charges)
    X = (coords - c) @ R
    ops = _find_ops(X, symbols, tol)
    full = [
        (_op_name(s), np.asarray(s, dtype=float),
         R @ np.diag(np.asarray(s, dtype=float)) @ R.T, perm)
        for s, perm in ops
    ]
    return SymmetryInfo(group=_group_name([s for s, _ in ops]), centroid=c,
                        R=R, ops=full, tol=tol)


# ---------------------------------------------------------------------------
# AO representation of an operation
# ---------------------------------------------------------------------------


def _monomial_rep(l: int, O: np.ndarray) -> np.ndarray:
    """M with (R f)(r) = f(O^T r) expanded over degree-l monomials:
    columns index the input monomial, rows the output monomial."""
    comps = cart_components(l)
    index = {cmp: i for i, cmp in enumerate(comps)}
    M = np.zeros((len(comps), len(comps)))
    # x_j -> sum_k O_kj x_k  (substitution r -> O^T r)
    for col, (i, j, k) in enumerate(comps):
        poly = {(0, 0, 0): 1.0}
        for axis, power in ((0, i), (1, j), (2, k)):
            for _ in range(power):
                new = {}
                for mono, coef in poly.items():
                    for ax2 in range(3):
                        w = O[ax2, axis]
                        if w == 0.0:
                            continue
                        m2 = list(mono)
                        m2[ax2] += 1
                        m2 = tuple(m2)
                        new[m2] = new.get(m2, 0.0) + coef * w
                poly = new
        for mono, coef in poly.items():
            M[index[mono], col] += coef
    return M


def _sph_rotation(l: int, O: np.ndarray) -> np.ndarray:
    """D^l(O) (2l+1, 2l+1) over the real solid harmonics of cart2sph:
    D = C^T A M C / N with A the angular overlap (harmonics are
    A-orthogonal with norm N = (2l-1)!!)."""
    C = cart2sph(l)
    A = _angular_overlap(l)
    M = _monomial_rep(l, O)
    N = float(double_factorial(2 * l - 1))
    return (C.T @ A @ M @ C) / N


def ao_representation(layout: BasisLayout, info: SymmetryInfo,
                      op_index: int) -> np.ndarray:
    """(nao, nao) matrix U of the op on the AO basis: (R phi)_nu =
    sum_mu U[mu, nu] phi_mu."""
    _, _, O, perm = info.ops[op_index]
    nao = layout.nao
    U = np.zeros((nao, nao))
    # shells grouped per atom, in construction order
    by_atom: dict = {}
    for sh in layout.shells:
        by_atom.setdefault(sh.atom_index, []).append(sh)
    Dcache = {}
    for a, shells in by_atom.items():
        target = by_atom[perm[a]]
        for k, sh in enumerate(shells):
            tsh = target[k]
            assert tsh.l == sh.l
            if sh.l not in Dcache:
                Dcache[sh.l] = _sph_rotation(sh.l, O)
            D = Dcache[sh.l]
            n = 2 * sh.l + 1
            U[tsh.ao_offset : tsh.ao_offset + n,
              sh.ao_offset : sh.ao_offset + n] = D
    return U


# ---------------------------------------------------------------------------
# irrep labels
# ---------------------------------------------------------------------------


def _label_from_chars(group: str, ops, chars) -> str:
    """Mulliken label from the +-1 characters over the group's ops.

    ops: list of op names (principal-frame convention); chars: dict
    name -> +-1.  B1/B2 (C2v) and B1/B2/B3 (D2/D2h) follow the
    z/y/x-axis convention of the principal frame."""
    def c(name, default=1):
        return chars.get(name, default)

    if group == "C1":
        return "A"
    if group == "Ci":
        return "Ag" if c("i") > 0 else "Au"
    if group == "Cs":
        sig = next(n for n in ops if n.startswith("s"))
        return "A'" if c(sig) > 0 else "A''"
    if group == "C2":
        c2 = next(n for n in ops if n.startswith("C2"))
        return "A" if c(c2) > 0 else "B"
    if group == "C2h":
        c2 = next(n for n in ops if n.startswith("C2"))
        par = "g" if c("i") > 0 else "u"
        return ("A" if c(c2) > 0 else "B") + par
    if group == "C2v":
        c2 = next(n for n in ops if n.startswith("C2"))
        sigs = sorted(n for n in ops if n.startswith("s"))
        s1 = sigs[0]
        if c(c2) > 0:
            return "A1" if c(s1) > 0 else "A2"
        return "B1" if c(s1) > 0 else "B2"
    if group in ("D2", "D2h"):
        cz, cy, cx = c("C2z"), c("C2y"), c("C2x")
        if cz > 0 and cy > 0:
            base = "A"
        elif cz > 0:
            base = "B1"
        elif cy > 0:
            base = "B2"
        else:
            base = "B3"
        if group == "D2":
            return base
        return base + ("g" if c("i") > 0 else "u")
    raise ValueError(group)


def mo_irreps(layout: BasisLayout, S: np.ndarray, C: np.ndarray,
              info: SymmetryInfo, strict: float = 0.05, mo_energy=None,
              degen_tol: float = 1e-6):
    """(labels, chars): per-MO Mulliken labels and character dicts.

    chi = c^T S U c per op; values are snapped to +-1.  Exactly
    degenerate MOs (pi pairs of linear molecules, ...) come out of an
    eigensolver as arbitrary mixtures within the degenerate block; when
    ``mo_energy`` is given, each degenerate cluster is symmetry-adapted
    by jointly diagonalizing the block representations of the group ops
    before reading characters (labels are assigned to the cluster in
    adapted order; the physics is invariant under this in-block
    rotation).  An MO whose character still deviates from +-1 by more
    than ``strict`` (genuinely symmetry-broken) is labeled '?'."""
    S = np.asarray(S)
    C = np.asarray(C)
    nmo = C.shape[1]
    names = [n for n, _, _, _ in info.ops if n != "E"]
    Us = {n: ao_representation(layout, info, k)
          for k, (n, _, _, _) in enumerate(info.ops) if n != "E"}

    # degeneracy clusters
    clusters = []
    if mo_energy is not None:
        e = np.asarray(mo_energy)
        start = 0
        for i in range(1, nmo + 1):
            if i == nmo or abs(e[i] - e[i - 1]) > degen_tol:
                clusters.append(list(range(start, i)))
                start = i
    else:
        clusters = [[i] for i in range(nmo)]

    Cw = C.copy()
    for cl in clusters:
        if len(cl) == 1:
            continue
        block = C[:, cl]
        # commuting +-1 reps on the cluster; a generic weighted sum has a
        # nondegenerate spectrum whose eigenbasis adapts all of them
        acc = np.zeros((len(cl), len(cl)))
        for j, n in enumerate(names):
            B = block.T @ S @ Us[n] @ block
            acc += (1.7 ** j) * 0.5 * (B + B.T)
        _, W = np.linalg.eigh(acc)
        Cw[:, cl] = block @ W

    chars = [dict() for _ in range(nmo)]
    ok = np.ones(nmo, dtype=bool)
    for n in names:
        chi = np.einsum("pi,pq,qi->i", Cw, S @ Us[n], Cw)
        snapped = np.where(chi >= 0, 1, -1)
        ok &= np.abs(chi - snapped) < strict
        for i in range(nmo):
            chars[i][n] = int(snapped[i])
    labels = [
        _label_from_chars(info.group, info.op_names, ch) if good else "?"
        for ch, good in zip(chars, ok)
    ]
    return labels, chars


def product_label(info: SymmetryInfo, ch1: dict, ch2: dict) -> str:
    """Direct product of two one-dimensional irreps (character product) —
    the reference's ``symm.direct_prod``."""
    prod = {n: ch1.get(n, 1) * ch2.get(n, 1) for n in info.op_names
            if n != "E"}
    return _label_from_chars(info.group, info.op_names, prod)

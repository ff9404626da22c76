"""Shell construction, normalization, and Cartesian→spherical transforms.

This is the foundation the reference outsources to libcint.  Conventions:

- contracted shells are segmented (general contractions split upstream,
  `chem/basis/__init__.py`)
- primitive coefficients absorb the normalization constant of the (l,0,0)
  Cartesian component; the contracted shell is then renormalized so the
  (l,0,0) component has unit self-overlap
- AOs are real spherical harmonics; p shells are ordered (x, y, z), shells
  with l >= 2 are ordered m = -l..l.  The cart→sph coefficient matrices are
  constructed from polynomial patterns and normalized *numerically* against
  the exact angular overlap matrix, which guarantees orthonormal spherical
  AOs without relying on transcription of c2s tables.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from xtddft_tpu_torch.chem import basis as basis_registry
from xtddft_tpu_torch.chem.molecule import Molecule


def double_factorial(n: int) -> int:
    if n <= 0:
        return 1
    out = 1
    while n > 0:
        out *= n
        n -= 2
    return out


def cart_components(l: int) -> list[tuple[int, int, int]]:
    """Cartesian monomial exponents for angular momentum l, lexicographic
    (x-major) order: e.g. d -> xx, xy, xz, yy, yz, zz."""
    return [
        (l - a, a - b, b)
        for a in range(l + 1)
        for b in range(a + 1)
    ]


def _angular_overlap(l: int) -> np.ndarray:
    """A[c1, c2] = df(i1+i2) df(j1+j2) df(k1+k2) (0 when any sum is odd).

    The full primitive overlap between degree-l monomial Gaussians factorizes
    into radial(p) * A; radial cancels in normalization (see module doc).
    """
    comps = cart_components(l)
    n = len(comps)
    A = np.zeros((n, n))
    for a, (i1, j1, k1) in enumerate(comps):
        for b, (i2, j2, k2) in enumerate(comps):
            if (i1 + i2) % 2 or (j1 + j2) % 2 or (k1 + k2) % 2:
                continue
            A[a, b] = (
                double_factorial(i1 + i2 - 1)
                * double_factorial(j1 + j2 - 1)
                * double_factorial(k1 + k2 - 1)
            )
    return A


# real solid harmonic polynomial patterns, in terms of raw monomials.
# values are {(i,j,k): coefficient}; overall scale fixed numerically.
def _sph_patterns(l: int) -> list[dict]:
    if l == 0:
        return [{(0, 0, 0): 1.0}]
    if l == 1:  # x, y, z (pyscf-style p ordering)
        return [{(1, 0, 0): 1.0}, {(0, 1, 0): 1.0}, {(0, 0, 1): 1.0}]
    if l == 2:  # m = -2..2
        return [
            {(1, 1, 0): 1.0},                                # xy
            {(0, 1, 1): 1.0},                                # yz
            {(0, 0, 2): 2.0, (2, 0, 0): -1.0, (0, 2, 0): -1.0},  # 3z^2-r^2
            {(1, 0, 1): 1.0},                                # xz
            {(2, 0, 0): 1.0, (0, 2, 0): -1.0},               # x^2-y^2
        ]
    if l == 3:  # m = -3..3
        return [
            {(2, 1, 0): 3.0, (0, 3, 0): -1.0},               # y(3x^2-y^2)
            {(1, 1, 1): 1.0},                                # xyz
            {(0, 1, 2): 4.0, (2, 1, 0): -1.0, (0, 3, 0): -1.0},  # y(5z^2-r^2)->y(4z^2-x^2-y^2)
            {(0, 0, 3): 2.0, (2, 0, 1): -3.0, (0, 2, 1): -3.0},  # z(5z^2-3r^2)
            {(1, 0, 2): 4.0, (3, 0, 0): -1.0, (1, 2, 0): -1.0},  # x(5z^2-r^2)
            {(2, 0, 1): 1.0, (0, 2, 1): -1.0},               # z(x^2-y^2)
            {(3, 0, 0): 1.0, (1, 2, 0): -3.0},               # x(x^2-3y^2)
        ]
    if l == 4:  # m = -4..4
        return [
            {(3, 1, 0): 1.0, (1, 3, 0): -1.0},               # xy(x^2-y^2)
            {(2, 1, 1): 3.0, (0, 3, 1): -1.0},               # yz(3x^2-y^2)
            {(1, 1, 2): 6.0, (3, 1, 0): -1.0, (1, 3, 0): -1.0},  # xy(7z^2-r^2)
            {(0, 1, 3): 4.0, (2, 1, 1): -3.0, (0, 3, 1): -3.0},  # yz(7z^2-3r^2)
            {(0, 0, 4): 8.0, (4, 0, 0): 3.0, (0, 4, 0): 3.0,
             (2, 2, 0): 6.0, (2, 0, 2): -24.0, (0, 2, 2): -24.0},  # 35z^4-30z^2 r^2+3r^4
            {(1, 0, 3): 4.0, (3, 0, 1): -3.0, (1, 2, 1): -3.0},  # xz(7z^2-3r^2)
            {(2, 0, 2): 6.0, (0, 2, 2): -6.0, (4, 0, 0): -1.0, (0, 4, 0): 1.0},  # (x^2-y^2)(7z^2-r^2)
            {(3, 0, 1): 1.0, (1, 2, 1): -3.0},               # xz(x^2-3y^2)
            {(4, 0, 0): 1.0, (2, 2, 0): -6.0, (0, 4, 0): 1.0},  # x^4-6x^2y^2+y^4
        ]
    raise NotImplementedError(f"l={l} > 4 not supported yet")


@lru_cache(maxsize=None)
def cart2sph(l: int) -> np.ndarray:
    """C (ncart, 2l+1) with columns normalized so that a spherical AO built
    from (l,0,0)-normalized Cartesian integrals has unit norm."""
    comps = cart_components(l)
    index = {c: i for i, c in enumerate(comps)}
    patterns = _sph_patterns(l)
    C = np.zeros((len(comps), len(patterns)))
    for m, pat in enumerate(patterns):
        for mono, coef in pat.items():
            C[index[mono], m] = coef
    A = _angular_overlap(l)
    norms = np.einsum("cm,cd,dm->m", C, A, C)
    target = float(double_factorial(2 * l - 1))
    C *= np.sqrt(target / norms)[None, :]
    return C


def nsph(l: int) -> int:
    return 2 * l + 1


def ncart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def primitive_norm(alpha: np.ndarray, l: int) -> np.ndarray:
    """Norm of the (l,0,0) Cartesian Gaussian x^l exp(-alpha r^2)."""
    df = double_factorial(2 * l - 1)
    return np.sqrt(
        (2.0 * alpha / np.pi) ** 1.5 * (4.0 * alpha) ** l / df
    )


@dataclasses.dataclass(frozen=True)
class Shell:
    l: int
    center: np.ndarray  # (3,)
    exps: np.ndarray  # (nprim,)
    coefs: np.ndarray  # (nprim,), normalized
    atom_index: int
    ao_offset: int  # first spherical AO index

    @property
    def nao(self) -> int:
        return nsph(self.l)


@dataclasses.dataclass(frozen=True)
class BasisLayout:
    mol: Molecule
    shells: tuple[Shell, ...]
    nao: int

    @property
    def ao_atoms(self) -> np.ndarray:
        """Atom index of each AO."""
        out = np.empty(self.nao, dtype=np.int64)
        for sh in self.shells:
            out[sh.ao_offset : sh.ao_offset + sh.nao] = sh.atom_index
        return out

    @property
    def ao_ls(self) -> np.ndarray:
        out = np.empty(self.nao, dtype=np.int64)
        for sh in self.shells:
            out[sh.ao_offset : sh.ao_offset + sh.nao] = sh.l
        return out


def _normalize_contraction(l: int, exps: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    c = coefs * primitive_norm(exps, l)
    # contracted self-overlap of the (l,0,0) component
    p = exps[:, None] + exps[None, :]
    df = double_factorial(2 * l - 1)
    s = (np.pi / p) ** 1.5 / (2.0 * p) ** l * df
    norm = np.einsum("i,j,ij->", c, c, s)
    return c / np.sqrt(norm)


def build_layout(mol: Molecule, basis: str | None = None) -> BasisLayout:
    basis_name = basis or mol.basis
    shells: list[Shell] = []
    offset = 0
    for ia, sym in enumerate(mol.symbols):
        for l, exps, coefs in basis_registry.get_element_basis(basis_name, sym):
            c = _normalize_contraction(l, exps, coefs)
            shells.append(
                Shell(
                    l=l,
                    center=mol.coords[ia].copy(),
                    exps=exps,
                    coefs=c,
                    atom_index=ia,
                    ao_offset=offset,
                )
            )
            offset += nsph(l)
    return BasisLayout(mol=mol, shells=tuple(shells), nao=offset)

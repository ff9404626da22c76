"""K5: the ERI-derivative contraction of the nuclear gradient.

Replaces the backward pass through `xtddft_tpu/ints/jaxints.py:589`
`_eri_block` (JAX's vjp of the ERIs of `make_integral_fn`, cotangent Gamma)
and `xtddft_tpu/grad/analytic.py:27` `_grad_eri_contract`:

    g[A, x] = sum_pqrs Gamma_pqrs d(pq|rs)/dA_x      (natm, 3)

over the spherical AO basis.  ``eri_grad`` makes Gamma 8-fold symmetric and
Cartesian (four products with the block-diagonal cart->sph map) and hands
it to the CUDA source (`csrc/eri_grad.cu`), which contracts it block by
block with the derivative integrals of every ordered bra shell pair and
unordered ket pair, built in registers and shared memory from the pairs'
Hermite expansions (made here, on the host, for each call: `GradPlan`) and
never written out.  A fixed summation order makes the result repeat
bitwise.  Shells up to d.

A CPU tensor takes the plain version: the vjp of `ints/diffints.py`'s ERIs
by autograd.  A CUDA tensor launches the kernel or raises.
``eri_of_coords`` is the autograd function through which the gradient's
Lagrangian meets the ERIs.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from xtddft_tpu_torch.ints import mcmurchie as md
from xtddft_tpu_torch.ints.shell import BasisLayout, build_layout, cart2sph, ncart
from xtddft_tpu_torch.ints.soc_ints import _deriv_table, _herm_recursion, _hermite, _nherm
from xtddft_tpu_torch.ints.two_electron import _comb_index, _herm_sign
from xtddft_tpu_torch.kernels import _cuda

NAME = "eri_grad"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/eri_grad.cu"
REPLACES = "xtddft_tpu/ints/jaxints.py:589"

launches = 0
mode_launches: dict[str, int] = {}

LMAX = 2  # shells up to d: the kernel's shared tables are sized for it
KET_CHUNK = 8  # ket pairs per block
PRIM_EPS = 1e-14  # the primitive-pair screening of `ints/diffints.py`
_PAIR_INTS = 8

_ARGS = [_cuda.P, _cuda.I, _cuda.P, _cuda.I, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.P,
         _cuda.P, _cuda.P, ctypes.c_double, _cuda.I, _cuda.P, _cuda.I, _cuda.P, _cuda.P]


def symmetrize8(G: torch.Tensor) -> torch.Tensor:
    """The part of Gamma with the 8-fold symmetry of (pq|rs)."""
    G = 0.5 * (G + G.permute(1, 0, 2, 3))
    G = 0.5 * (G + G.permute(0, 1, 3, 2))
    return 0.5 * (G + G.permute(2, 3, 0, 1))


def cart_map(layout: BasisLayout) -> tuple[np.ndarray, np.ndarray]:
    """(T (ncart, nao) block-diagonal cart->sph map, Cartesian offset of
    each shell): spherical integrals are T^T (Cartesian) T on each index."""
    off = np.cumsum([0] + [ncart(sh.l) for sh in layout.shells])
    T = np.zeros((off[-1], layout.nao))
    for k, sh in enumerate(layout.shells):
        T[off[k]:off[k + 1], sh.ao_offset:sh.ao_offset + sh.nao] = cart2sph(sh.l)
    return T, off[:-1]


def _prims(sha, shb):
    """Exponents and contraction products of a pair's primitive pairs,
    screened as `diffints._PairClass.add` screens them."""
    a = np.repeat(sha.exps, len(shb.exps))
    b = np.tile(shb.exps, len(sha.exps))
    cc = np.repeat(sha.coefs, len(shb.coefs)) * np.tile(shb.coefs, len(sha.coefs))
    p = a + b
    ab2 = float(np.sum((sha.center - shb.center) ** 2))
    est = np.abs(cc) * (np.pi / p) ** 1.5 * np.exp(-a * b / p * ab2)
    keep = est >= PRIM_EPS
    if not keep.any():
        keep[np.argmax(est)] = True
    return a[keep], b[keep], cc[keep]


def _class_tables(la, lb, pairs, deriv: bool):
    """Hermite tables of the pairs (sha, shb) of one class, all primitive
    pairs at once: (tables per primitive, p and P per primitive, primitive
    count per pair).  deriv: (3, ncab, nherm(la+lb+1)) per primitive of
    (d/dr_x a) b; else (ncab, nherm(la+lb)) with the ket parity folded in."""
    prim = [_prims(sa, sb) for sa, sb in pairs]
    counts = np.array([len(x[0]) for x in prim])
    a = np.concatenate([x[0] for x in prim])
    b = np.concatenate([x[1] for x in prim])
    cc = np.concatenate([x[2] for x in prim])
    A = np.repeat(np.stack([sa.center for sa, _ in pairs]), counts, axis=0)
    B = np.repeat(np.stack([sb.center for _, sb in pairs]), counts, axis=0)
    AB = A - B
    p = a + b
    P = (a[:, None] * A + b[:, None] * B) / p[:, None]
    ld = 1 if deriv else 0
    E = [md.e_coeffs_1d(la + ld, lb + ld, a, b, AB[:, d]) for d in range(3)]
    if deriv:
        L = la + lb + 1
        H = np.stack([_hermite([_deriv_table(E[dd], la, lb, a, b, "d" if dd == x else None,
                                             None, L + 1) for dd in range(3)], la, lb, L) * cc
                      for x in range(3)])  # (3, ncab, nherm, nprim)
        tab = H.transpose(3, 0, 1, 2)
    else:
        L = la + lb
        H = _hermite([E[dd][:, :, :L + 1] for dd in range(3)], la, lb, L) * cc
        tab = (H * _herm_sign(L)[None, :, None]).transpose(2, 0, 1)
    return (np.ascontiguousarray(tab).reshape(len(a), -1), np.column_stack([p, P]), counts)


@lru_cache(maxsize=None)
def _htab() -> np.ndarray:
    """The kernel's index tables: the Hermite recursion of order 9 (axis,
    prev, prev2, coef) and the combined index of orders 5 and 4 (rows
    padded to 35), all in `herm_indices(9)` order."""
    axis, prev, prev2, coef = _herm_recursion(9)
    hsum = _comb_index(5, 4)
    return np.concatenate([axis, prev, prev2, coef.astype(np.int64), hsum.reshape(-1)]).astype(
        np.int32)


class GradPlan:
    """Everything K5 reads besides Gamma, for one layout (its geometry) on
    one device: the pair tables (int32 rows of la, lb, Cartesian offsets
    of the two shells, the bra's atom or the ket's mirror factor, first
    primitive, primitive count, table offset), each primitive's (p, P) and
    Hermite table, the index tables, the cart->sph map, and the operation
    count of this basis's contraction (for the bound)."""

    def __init__(self, layout: BasisLayout, device, dtype=torch.float64):
        shells = layout.shells
        if max(sh.l for sh in shells) > LMAX:
            raise NotImplementedError(
                f"{NAME}: shells up to l={LMAX} (d); this basis has l="
                f"{max(sh.l for sh in shells)}")
        T, coff = cart_map(layout)
        self.nc = T.shape[0]
        self.natm = layout.mol.natm
        nsh = len(shells)
        sides = {}
        for deriv, plist in ((True, [(i, j) for i in range(nsh) for j in range(nsh)]),
                             (False, [(i, j) for i in range(nsh) for j in range(i, nsh)])):
            groups: dict = {}
            for k, (i, j) in enumerate(plist):
                groups.setdefault((shells[i].l, shells[j].l), []).append(k)
            rows = np.zeros((len(plist), _PAIR_INTS), dtype=np.int64)
            tabs, pPs = [], []
            nprim = ntab = 0
            for (la, lb), members in groups.items():
                tab, pP, counts = _class_tables(
                    la, lb, [(shells[plist[k][0]], shells[plist[k][1]]) for k in members], deriv)
                width = tab.shape[1]
                starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
                for k, s, c in zip(members, starts, counts):
                    i, j = plist[k]
                    rows[k] = (la, lb, coff[i], coff[j],
                               shells[i].atom_index if deriv else (1 if i == j else 2),
                               nprim + s, c, ntab + s * width)
                tabs.append(tab.reshape(-1))
                pPs.append(pP)
                nprim += len(pP)
                ntab += tab.size
            if ntab >= 2 ** 31:
                raise ValueError(f"{NAME}: {ntab} table entries overflow int32 offsets")
            sides[deriv] = (rows, np.concatenate(pPs), np.concatenate(tabs))
        (self.bra_rows, bra_pP, bra_tab), (self.ket_rows, ket_pP, ket_tab) = sides[True], sides[False]
        self.flops = _flops(self.bra_rows, self.ket_rows)

        def dev(x, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

        self.bra = dev(self.bra_rows, torch.int32)
        self.ket = dev(self.ket_rows, torch.int32)
        self.bra_pP, self.bra_tab = dev(bra_pP), dev(bra_tab)
        self.ket_pP, self.ket_tab = dev(ket_pP), dev(ket_tab)
        self.htab = dev(_htab(), torch.int32)
        self.T = dev(T)
        self.table_bytes = sum(t.numel() * t.element_size() for t in (
            self.bra, self.ket, self.bra_pP, self.bra_tab, self.ket_pP, self.ket_tab))

    def nbytes(self, nao: int, itemsize: int = 8) -> int:
        """Gamma read once, the tables read once, g written once."""
        return nao ** 4 * itemsize + self.table_bytes + 3 * self.natm * itemsize


def _flops(bra_rows, ket_rows) -> float:
    """Operations of the kernel's contraction on this basis: per (bra pair,
    ket pair, ket primitive) the fold of Gamma into the ket expansion, per
    primitive quartet the Hermite recursion and the contraction with the
    three derivative expansions (the Boys function not counted)."""
    def side(rows, dl):
        la, lb, nprim = rows[:, 0], rows[:, 1], rows[:, 6]
        nab = ((la + 1) * (la + 2) // 2) * ((lb + 1) * (lb + 2) // 2)
        return nab, la + lb + dl, nprim.astype(np.float64)
    nab, Lb, pb = side(bra_rows, 1)
    ncd, Lk, pk = side(ket_rows, 0)
    nh = np.vectorize(_nherm)
    nh1, nh2 = nh(Lb)[:, None], nh(Lk)[None, :]
    L = Lb[:, None] + Lk[None, :]
    rec = 3.0 * np.array([sum(_nherm(k) for k in range(l + 1)) for l in range(10)])[L]
    kt = 2.0 * nab[:, None] * ncd[None, :] * nh2 * pk[None, :]
    per_q = (2.0 * nh2 + 6.0) * nab[:, None] * nh1 + rec
    return float(np.sum(kt + per_q * pb[:, None] * pk[None, :]))


def eri_grad_plain(layout: BasisLayout, Gamma: torch.Tensor, omega: float = 0.0) -> torch.Tensor:
    """g by autograd: the vjp of `ints/diffints.py`'s ERIs with cotangent
    Gamma, on Gamma's device."""
    from xtddft_tpu_torch.ints import diffints

    coords = torch.tensor(layout.mol.coords, dtype=Gamma.dtype, device=Gamma.device,
                          requires_grad=True)
    with torch.enable_grad():
        eri = diffints.make_eri_fn(layout, omega)(coords)
        return torch.autograd.grad(eri, coords, Gamma)[0]


def launch(p: GradPlan, Gc: torch.Tensor, omega: float = 0.0) -> torch.Tensor:
    """K5 on a symmetrized Cartesian Gamma (ncart^4), f64: g (natm, 3)."""
    global launches
    _cuda.require_cuda(NAME, Gc)
    if Gc.dtype != torch.float64:
        raise TypeError(f"{NAME}: float64 only, got {Gc.dtype}")
    Gc = Gc.contiguous()
    nbra, nket = p.bra_rows.shape[0], p.ket_rows.shape[0]
    nchunk = -(-nket // KET_CHUNK)
    partial = torch.empty(nbra * nchunk * 3, dtype=Gc.dtype, device=Gc.device)
    g = torch.empty((p.natm, 3), dtype=Gc.dtype, device=Gc.device)
    lib, fn = _cuda.entry(NAME, _ARGS, Gc.dtype)
    rc = fn(Gc.data_ptr(), p.nc, p.bra.data_ptr(), nbra, p.bra_pP.data_ptr(),
            p.bra_tab.data_ptr(), p.ket.data_ptr(), nket, p.ket_pP.data_ptr(),
            p.ket_tab.data_ptr(), p.htab.data_ptr(), float(omega), KET_CHUNK,
            partial.data_ptr(), p.natm, g.data_ptr(), _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    return g


def to_cart(p: GradPlan, G: torch.Tensor) -> torch.Tensor:
    """T G T^T on each of the four indices."""
    n = G.shape[0]
    for _ in range(4):
        G = (p.T @ G.reshape(n, -1)).reshape(p.nc, *G.shape[1:]).permute(1, 2, 3, 0)
        n = G.shape[0]
    return G.contiguous()


def eri_grad(layout: BasisLayout, Gamma: torch.Tensor, omega: float = 0.0) -> torch.Tensor:
    """g[A, x] = sum_pqrs Gamma_pqrs d(pq|rs)/dA_x, (natm, 3), for ``layout``'s
    geometry; ``omega`` > 0: the erf(omega r)/r ERIs.  Gamma (nao^4) of any
    symmetry."""
    nao = layout.nao
    if tuple(Gamma.shape) != (nao,) * 4:
        raise ValueError(f"{NAME}: Gamma {tuple(Gamma.shape)} for {nao} AOs")
    if Gamma.device.type == "cpu":
        return eri_grad_plain(layout, Gamma, omega)
    p = GradPlan(layout, Gamma.device)
    return launch(p, to_cart(p, symmetrize8(Gamma.to(torch.float64))), omega).to(Gamma.dtype)


def _layout_at(layout: BasisLayout, coords: np.ndarray) -> BasisLayout:
    if np.array_equal(coords, layout.mol.coords):
        return layout
    return build_layout(layout.mol.with_(coords=coords))


class _EriOfCoords(torch.autograd.Function):
    @staticmethod
    def forward(coords, layout, omega):
        from xtddft_tpu_torch.ints.two_electron import eri_full

        lay = _layout_at(layout, coords.detach().cpu().numpy().astype(np.float64))
        return torch.as_tensor(eri_full(lay, omega=omega or None), dtype=coords.dtype,
                               device=coords.device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        coords, layout, omega = inputs
        ctx.layout = _layout_at(layout, coords.detach().cpu().numpy().astype(np.float64))
        ctx.omega = omega

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, Gamma):
        return eri_grad(ctx.layout, Gamma, ctx.omega), None, None


def eri_of_coords(coords: torch.Tensor, layout: BasisLayout, omega: float = 0.0) -> torch.Tensor:
    """The ERIs (pq|rs) at ``coords`` (natm, 3, bohr) on coords' device,
    from the native engine, as an autograd node whose backward is K5 on
    CUDA tensors (its plain version on CPU ones).  Only first derivatives in
    the coordinates exist: the ERIs enter the gradient's Lagrangian
    linearly, so the backward itself is not differentiable."""
    return _EriOfCoords.apply(coords, layout, float(omega or 0.0))


__all__ = ["eri_grad", "eri_grad_plain", "eri_of_coords", "GradPlan", "symmetrize8", "launch",
           "to_cart"]

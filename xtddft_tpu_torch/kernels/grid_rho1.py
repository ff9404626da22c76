"""K2: transition density, and optionally its gradient, on a span of grid points.

Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.rho1`
(:495-508) and the transition density of the spin-flip sigmas (:857-867,
:1105-1120), where the virtual side may read a second MO table (``phi_v``:
the other spin's, for a UKS reference) and the ALDA0 kernel needs the value
row alone (``ncomp=1``).  The CUDA source (`csrc/grid_rho1.cu`) runs it as
the two GEMMs of the GGA minimum on the tile core of `csrc/gemm_tile.cuh`:
tmp = z . pv_0 (M = vectors x occupied rows, N = points, K = nvir) and
u = z^T . po_0 (M = vectors x virtual rows, K = nocc), each contracted with
the MO table in a tile epilogue, so nothing of size nz*npts*norb reaches
device memory; the value row alone is one of them.  It is bound by flops:
4*nz*nocc*nvir per grid point with the gradient, 2*nz*nocc*nvir for the
value alone (`response/flops.py`), which it does.  A sigma calls it once
per point span.  The hermitian mode (``hermi=True``) is the SCF's density
on the grid, `xtddft_tpu/xc/interface.py:53` `cache_rho`: the AO table on
both sides and symmetric density matrices as z, where the tmp GEMM alone
gives the value row and half the gradient, one GEMM of 2*nz*nao^2 per
point, as the plain version does.  The wrapper lays z out as the GEMMs' A
operands (`operands`).  ``fixed_order=True`` (the SCF's density) stores
each partial sum of a point in its own slot of a workspace and adds the
slots in a fixed order: bitwise-repeatable sums.  A CPU tensor takes the
plain torch version below; a CUDA tensor launches the kernel or raises.

``ncomp=5`` adds the meta-GGA row, the transition kinetic-energy density
t = 1/2 sum_y sum_ov z_ov d_y phi_o d_y phi_v (`sigma_df.py:505-507`, the
flip `:1121-1124`, and in the hermitian mode `xc/interface.py:53`
``cache_rho(tau=True)``): three more GEMMs tmp_y = z . pv_y (M = vectors x
occupied rows, K = nvir, the A operand of tmp), each dotted with po_y in
the tile epilogue into row 4, at 6*nz*nocc*nvir more flops per point.
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels import _cuda

NAME = "grid_rho1"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/grid_rho1.cu"
REPLACES = "xtddft_tpu/response/sigma_df.py:495"
# the kernel indexes points with 32-bit ints, a point tile of headroom kept
MAX_POINTS = (1 << 31) - 256

launches = 0
# launches by mode, counted with ``launches``: the meta-GGA tau row
mode_launches = {"tau": 0}

_ARGS = [_cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.I,
         _cuda.P, _cuda.I, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
         _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P, _cuda.P, _cuda.L,
         _cuda.P]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# rows the kernel's tile epilogue sums at once, by element size: each trial
# vector's rows are padded to a multiple of it
_ROW_GROUP = {4: 4, 8: 8}
# row groups in half a row tile (128 rows in f32, 64 in f64): the unit of
# the fixed-order mode's slots
_HALF_TILE_GROUPS = {4: 16, 8: 4}


def fixed_order_slots(nz: int, ra: int, rb: int, ncomp: int, gc: int, itemsize: int) -> int:
    """Elements of one split's slots in the fixed-order mode, over both
    GEMMs: a slot per vector, half row tile its rows can span, component and
    point."""
    rg, qh = _ROW_GROUP[itemsize], _HALF_TILE_GROUPS[itemsize]
    spans = max((r // rg - 1) // qh + 2 for r in (ra, rb) if r > 0)
    return nz * spans * min(ncomp, 4) * gc


def operands(z: torch.Tensor, o0: int, v0: int, ncomp: int, hermi: bool = False):
    """z (nz, nocc, nvir) laid out as the kernel's A operands, k-major:
    za[sv + v, x, so + o] = z[x, o, v], of shape (sv + nvir, nz, ra), for
    the GEMM tmp = z . pv_0, and zb[so + o, x, sv + v] = z[x, o, v], of
    shape (so + nocc, nz, rb), for u = z^T . po_0; zero elsewhere.  The
    shifts so = o0 % w and sv = v0 % w (w elements in 16 bytes) start the
    tables' 16-byte runs on aligned columns; ra and rb pad each vector's rows
    to a multiple of the epilogue's row group.  The value row goes with the
    GEMM of fewer rows (``vu``: with u, when nvir < nocc), the gradient rows
    with both, so the value row alone needs one operand and the other is
    None (its row count 0).  The tau row (``ncomp=5``) runs on za.  The
    hermitian mode takes tmp alone for every row.  Returns (so, sv, za, ra,
    zb, rb, vu)."""
    nz, nocc, nvir = z.shape
    w = 16 // z.element_size()
    rg = _ROW_GROUP[z.element_size()]
    so, sv = o0 % w, v0 % w
    vu = nvir < nocc and not hermi
    both = ncomp >= 4 and not hermi
    za, ra, zb, rb = None, 0, None, 0
    if both or not vu:
        ra = _round_up(so + nocc, rg)
        za = torch.zeros((sv + nvir, nz, ra), dtype=z.dtype, device=z.device)
        za[sv:, :, so:so + nocc] = z.permute(2, 0, 1)
    if both or vu:
        rb = _round_up(sv + nvir, rg)
        zb = torch.zeros((so + nocc, nz, rb), dtype=z.dtype, device=z.device)
        zb[so:, :, sv:sv + nvir] = z.permute(1, 0, 2)
    return so, sv, za, ra, zb, rb, vu


def grid_rho1_plain(phi: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                    mask: torch.Tensor | None = None, phi_v: torch.Tensor | None = None,
                    ncomp: int = 4, hermi: bool = False) -> torch.Tensor:
    """(nz, ncomp, gc): [rho1, d/dx, d/dy, d/dz, tau][:ncomp] by the
    einsums of the JAX code (with ``hermi``, of `xc/interface.py:53`
    `cache_rho`: one product, the gradient doubled)."""
    nz, nocc, nvir = z.shape
    o = slice(o0, o0 + nocc)
    v = slice(v0, v0 + nvir)
    pv = phi if phi_v is None else phi_v
    tmp = torch.einsum("xov,gv->xgo", z, pv[0][:, v])
    out = torch.einsum("xgo,go->xg", tmp, phi[0][:, o])[:, None]
    if ncomp == 5 or (ncomp == 4 and not hermi):
        tmp2 = torch.einsum("xov,ygv->xygo", z, pv[1:4][:, :, v])
    if ncomp >= 4 and hermi:
        out = torch.cat([out, 2.0 * torch.einsum("xgo,ygo->xyg", tmp, phi[1:4][:, :, o])], dim=1)
    elif ncomp >= 4:
        g = torch.einsum("xgo,ygo->xyg", tmp, phi[1:4][:, :, o])
        g = g + torch.einsum("xygo,go->xyg", tmp2, phi[0][:, o])
        out = torch.cat([out, g], dim=1)
    if ncomp == 5:
        t = 0.5 * torch.einsum("xygo,ygo->xg", tmp2, phi[1:4][:, :, o])
        out = torch.cat([out, t[:, None]], dim=1)
    if mask is None:
        return out
    return torch.where(mask != 0, out, torch.zeros((), dtype=out.dtype, device=out.device))


def grid_rho1(phi: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
              mask: torch.Tensor | None = None, phi_v: torch.Tensor | None = None,
              ncomp: int = 4, hermi: bool = False, fixed_order: bool = False) -> torch.Tensor:
    """rho1[x, 0, g] = sum_ov z[x,o,v] phi[0,g,o0+o] phi_v[0,g,v0+v] and,
    with ``ncomp=4``, its gradient rho1[x, 1:4, g], with ``ncomp=5`` also
    rho1[x, 4, g] = 1/2 sum_y sum_ov z[x,o,v] phi[y,g,o0+o] phi_v[y,g,v0+v]
    (the kinetic-energy density); zero where ``mask`` (gc,) is 0.

    phi, phi_v (default phi): (>= min(ncomp, 4), gc, nmo) spans of the MO grid
    tables of the occupied and the virtual side, any strides; z: (nz, nocc,
    nvir); mask: 0/1 in the working dtype, or None for no masking.

    ``hermi=True``: z symmetric (nz, n, n) on one table (``phi_v`` None,
    o0 == v0), as the SCF's density matrices on the AO table are; the
    caller vouches for the symmetry, the shapes are checked.  ``fixed_order``:
    the partial sums of each point are added in a fixed order (bitwise
    repeatable)."""
    global launches
    if ncomp not in (1, 4, 5):
        raise ValueError(f"{NAME}: ncomp {ncomp}, expected 1, 4 or 5")
    if hermi and (phi_v is not None or o0 != v0 or z.shape[1] != z.shape[2]):
        raise ValueError(f"{NAME}: the hermitian mode needs one table, o0 == v0 and square "
                         f"z, got phi_v {phi_v is not None}, o0={o0}, v0={v0}, "
                         f"z {tuple(z.shape)}")
    if phi.device.type == "cpu":
        return grid_rho1_plain(phi, z, o0, v0, mask, phi_v, ncomp, hermi)
    pv = phi if phi_v is None else phi_v
    _cuda.require_cuda(NAME, phi, pv, z, *(() if mask is None else (mask,)))
    nrow, gc, nmo = phi.shape
    nz, nocc, nvir = z.shape
    nt = min(ncomp, 4)  # table rows read
    if (nrow < nt or pv.shape[0] < nt or pv.shape[1:] != (gc, nmo)
            or o0 + nocc > nmo or v0 + nvir > nmo
            or (mask is not None and mask.shape != (gc,))):
        raise ValueError(f"{NAME}: phi {tuple(phi.shape)}, phi_v {tuple(pv.shape)}, "
                         f"z {tuple(z.shape)}, o0={o0}, v0={v0}, ncomp={ncomp} disagree")
    if min(nz, nocc, nvir, gc) < 1 or gc > MAX_POINTS:
        raise ValueError(f"{NAME}: z {tuple(z.shape)} on {gc} points: an empty extent, "
                         f"or more than {MAX_POINTS} points in one launch")
    so, sv, za, ra, zb, rb, vu = operands(z, o0, v0, ncomp, hermi)
    if mask is not None:
        mask = mask.contiguous()
    out = torch.zeros((nz, ncomp, gc), dtype=z.dtype, device=z.device)
    W = (_cuda.workspace(fixed_order_slots(nz, ra, rb, ncomp, gc, z.element_size()), z)
         if fixed_order else None)
    lib, fn = _cuda.entry(NAME, _ARGS, phi.dtype)
    rc = fn(phi.data_ptr(), *phi.stride(), pv.data_ptr(), *pv.stride(), gc,
            None if za is None else za.data_ptr(), ra, None if zb is None else zb.data_ptr(), rb,
            so, sv, nz, nocc, nvir, o0, v0, ncomp, int(vu), int(hermi),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if W is None else W.data_ptr(), 0 if W is None else W.numel(), _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    if ncomp == 5:
        mode_launches["tau"] += 1
    return out

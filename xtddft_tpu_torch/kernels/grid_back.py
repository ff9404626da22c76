"""K3: back-projection of a weighted grid response to (occ, vir).

Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.back`
(:525-534) and the back-projection of the spin-flip sigmas (:861-863,
:873-878, :1113-1132), where the virtual side may read a second MO table
(``phi_v``: the other spin's, for a UKS reference) and the ALDA0 kernel
carries the value component alone (``dwg=None``).  The CUDA source
(`csrc/grid_back.cu`) runs it as one GEMM on the tile core of
`csrc/gemm_tile.cuh` with M = nz*nocc, N = nvir and K = components x the
points, forming the combined factors F in shared memory as each tile of phi
lands; a sigma calls it once per point span.  It is bound by flops, at least
4*nz*nocc*nvir per grid point with the gradient (`response/flops.py`;
contracting over 4 components, it does twice that) and 2*nz*nocc*nvir for
the value alone (which it does exactly).  ``fixed_order=True`` (the SCF's
Fock build) adds the point-split partials in a fixed order through a
workspace: bitwise-repeatable sums.  A CPU tensor takes the plain torch
version below; a CUDA tensor launches the kernel or raises.

``dwt`` adds the meta-GGA term, sum_g 1/2 dwt sum_y po_y pv_y
(`sigma_df.py:531-533`, the flip `:1131-1133`, and on the AO table
`xc/interface.py:112` ``_contract_vmat(wtau=...)``), as a fifth weight row:
F_y = dwg_y po_0 + 1/2 dwt po_y in the same GEMM, whose K stays 4 x the
points; with it the least the function needs is what the kernel does.
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels import _cuda

NAME = "grid_back"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/grid_back.cu"
REPLACES = "xtddft_tpu/response/sigma_df.py:525"

launches = 0
# launches by mode, counted with ``launches``: the meta-GGA tau term
mode_launches = {"tau": 0}

_ARGS = [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.P, _cuda.L, _cuda.L,
         _cuda.L, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P,
         _cuda.L, _cuda.P]


def grid_back_plain(dwv: torch.Tensor, dwg: torch.Tensor | None, phi: torch.Tensor,
                    o0: int, v0: int, out: torch.Tensor,
                    phi_v: torch.Tensor | None = None,
                    dwt: torch.Tensor | None = None) -> torch.Tensor:
    """out += r by the einsums of the JAX code; returns out."""
    nz, nocc, nvir = out.shape
    o = slice(o0, o0 + nocc)
    v = slice(v0, v0 + nvir)
    pv = phi if phi_v is None else phi_v
    tmp = torch.einsum("xg,go->xgo", dwv, phi[0][:, o])
    if dwg is not None:
        tmp = tmp + torch.einsum("xyg,ygo->xgo", dwg, phi[1:4][:, :, o])
    r = torch.einsum("xgo,gv->xov", tmp, pv[0][:, v])
    if dwg is not None:
        tmp2 = torch.einsum("xyg,go->xygo", dwg, phi[0][:, o])
        r = r + torch.einsum("xygo,ygv->xov", tmp2, pv[1:4][:, :, v])
    if dwt is not None:
        r = r + 0.5 * torch.einsum("xg,ygo,ygv->xov", dwt, phi[1:4][:, :, o], pv[1:4][:, :, v])
    out += r
    return out


def grid_back(dwv: torch.Tensor, dwg: torch.Tensor | None, phi: torch.Tensor,
              o0: int, v0: int, out: torch.Tensor,
              phi_v: torch.Tensor | None = None, fixed_order: bool = False,
              dwt: torch.Tensor | None = None) -> torch.Tensor:
    """out[x,o,v] += sum_g (dwv po_0 + sum_y dwg_y po_y) pv_0
    + sum_g sum_y (dwg_y po_0 + 1/2 dwt po_y) pv_y, with po = phi[:, :, o0+o]
    and pv = phi_v[:, :, v0+v] (no dwt term without ``dwt``); with
    ``dwg=None`` the value term sum_g dwv po_0 pv_0 alone; returns out.

    dwv: (nz, gc); dwg: (nz, 3, gc) or None; dwt: (nz, gc) or None (only
    with dwg); phi, phi_v (default phi): (4,
    gc, nmo) spans of gc grid points of the MO grid tables of the occupied
    and the virtual side (at least the value row when ``dwg`` is None), any
    strides; out: (nz, nocc, nvir) contiguous accumulator.  ``fixed_order``:
    the partial sums are added in a fixed order (bitwise repeatable)."""
    global launches
    if dwt is not None and dwg is None:
        raise ValueError(f"{NAME}: the tau term (dwt) needs the gradient term (dwg)")
    if phi.device.type == "cpu":
        return grid_back_plain(dwv, dwg, phi, o0, v0, out, phi_v, dwt)
    pv = phi if phi_v is None else phi_v
    ncomp = 1 if dwg is None else 4
    _cuda.require_cuda(NAME, phi, pv, dwv, out, *(() if dwg is None else (dwg,)),
                       *(() if dwt is None else (dwt,)))
    nrow, gc, nmo = phi.shape
    nz, nocc, nvir = out.shape
    if (nrow < ncomp or pv.shape[0] < ncomp or pv.shape[1:] != (gc, nmo)
            or dwv.shape != (nz, gc) or (dwg is not None and dwg.shape != (nz, 3, gc))
            or (dwt is not None and dwt.shape != (nz, gc))
            or o0 + nocc > nmo or v0 + nvir > nmo or not out.is_contiguous()):
        raise ValueError(f"{NAME}: phi {tuple(phi.shape)}, phi_v {tuple(pv.shape)}, "
                         f"dwv {tuple(dwv.shape)}, dwg "
                         f"{None if dwg is None else tuple(dwg.shape)}, "
                         f"out {tuple(out.shape)}, o0={o0}, v0={v0} disagree")
    if min(nz, nocc, nvir, gc) < 1:
        raise ValueError(f"{NAME}: empty extent in out {tuple(out.shape)} on {gc} points")
    dwv = dwv.contiguous()
    if dwg is not None:
        dwg = dwg.contiguous()
    if dwt is not None:
        dwt = dwt.contiguous()
    W = _cuda.workspace(out.numel(), out) if fixed_order else None
    lib, fn = _cuda.entry(NAME, _ARGS, phi.dtype)
    rc = fn(dwv.data_ptr(), None if dwg is None else dwg.data_ptr(),
            None if dwt is None else dwt.data_ptr(), phi.data_ptr(),
            *phi.stride(), pv.data_ptr(), *pv.stride(), gc, nz, nocc, nvir, o0, v0,
            out.data_ptr(), None if W is None else W.data_ptr(), 0 if W is None else W.numel(),
            _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    if dwt is not None:
        mode_launches["tau"] += 1
    return out

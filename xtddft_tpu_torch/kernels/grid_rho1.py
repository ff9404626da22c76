"""K2: transition density, and optionally its gradient, on a span of grid points.

Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.rho1`
(:495-508) and the transition density of the spin-flip sigmas (:857-867,
:1105-1120), where the virtual side may read a second MO table (``phi_v``:
the other spin's, for a UKS reference) and the ALDA0 kernel needs the value
row alone (``ncomp=1``).  The CUDA kernel (`csrc/grid_rho1.cu`) keeps the
intermediate tmp[x, g, o] in registers and is bound by flops (at least
2*2*nocc*nvir per vector and grid point with the gradient,
`response/flops.py`; it does twice that; 2*nocc*nvir for the value alone);
see the source for its design.  A CPU tensor takes the plain torch version
below; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels import _cuda

NAME = "grid_rho1"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/grid_rho1.cu"
REPLACES = "xtddft_tpu/response/sigma_df.py:495"
MAX_POINTS = 65535 * 32  # one launch's grid extent over the points

launches = 0

_ARGS = [_cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.I,
         _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P,
         _cuda.P]


def grid_rho1_plain(phi: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                    mask: torch.Tensor | None = None, phi_v: torch.Tensor | None = None,
                    ncomp: int = 4) -> torch.Tensor:
    """(nz, ncomp, gc): [rho1, d/dx, d/dy, d/dz][:ncomp] by the einsums of
    the JAX code."""
    nz, nocc, nvir = z.shape
    o = slice(o0, o0 + nocc)
    v = slice(v0, v0 + nvir)
    pv = phi if phi_v is None else phi_v
    tmp = torch.einsum("xov,gv->xgo", z, pv[0][:, v])
    out = torch.einsum("xgo,go->xg", tmp, phi[0][:, o])[:, None]
    if ncomp == 4:
        g = torch.einsum("xgo,ygo->xyg", tmp, phi[1:4][:, :, o])
        tmp2 = torch.einsum("xov,ygv->xygo", z, pv[1:4][:, :, v])
        g = g + torch.einsum("xygo,go->xyg", tmp2, phi[0][:, o])
        out = torch.cat([out, g], dim=1)
    if mask is None:
        return out
    return torch.where(mask != 0, out, torch.zeros((), dtype=out.dtype, device=out.device))


def grid_rho1(phi: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
              mask: torch.Tensor | None = None, phi_v: torch.Tensor | None = None,
              ncomp: int = 4) -> torch.Tensor:
    """rho1[x, 0, g] = sum_ov z[x,o,v] phi[0,g,o0+o] phi_v[0,g,v0+v] and,
    with ``ncomp=4``, its gradient rho1[x, 1:4, g]; zero where ``mask``
    (gc,) is 0.

    phi, phi_v (default phi): (>= ncomp, gc, nmo) spans of the MO grid
    tables of the occupied and the virtual side, any strides; z: (nz, nocc,
    nvir); mask: 0/1 in the working dtype, or None for no masking."""
    global launches
    if ncomp not in (1, 4):
        raise ValueError(f"{NAME}: ncomp {ncomp}, expected 1 or 4")
    if phi.device.type == "cpu":
        return grid_rho1_plain(phi, z, o0, v0, mask, phi_v, ncomp)
    pv = phi if phi_v is None else phi_v
    _cuda.require_cuda(NAME, phi, pv, z, *(() if mask is None else (mask,)))
    nrow, gc, nmo = phi.shape
    nz, nocc, nvir = z.shape
    if (nrow < ncomp or pv.shape[0] < ncomp or pv.shape[1:] != (gc, nmo)
            or o0 + nocc > nmo or v0 + nvir > nmo
            or (mask is not None and mask.shape != (gc,))):
        raise ValueError(f"{NAME}: phi {tuple(phi.shape)}, phi_v {tuple(pv.shape)}, "
                         f"z {tuple(z.shape)}, o0={o0}, v0={v0}, ncomp={ncomp} disagree")
    if min(nz, nocc, nvir, gc) < 1 or gc > MAX_POINTS:
        raise ValueError(f"{NAME}: z {tuple(z.shape)} on {gc} points: an empty extent, "
                         f"or more than {MAX_POINTS} points in one launch")
    z = z.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    out = torch.zeros((nz, ncomp, gc), dtype=z.dtype, device=z.device)
    lib, fn = _cuda.entry(NAME, _ARGS, phi.dtype)
    rc = fn(phi.data_ptr(), *phi.stride(), pv.data_ptr(), *pv.stride(), gc, z.data_ptr(),
            nz, nocc, nvir, o0, v0, ncomp, None if mask is None else mask.data_ptr(),
            out.data_ptr(), _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    return out

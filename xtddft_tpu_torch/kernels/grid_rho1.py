"""K2: transition density and its gradient on one grid chunk.

Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.rho1`
(:495-508).  The CUDA kernel (`csrc/grid_rho1.cu`) keeps the intermediate
tmp[x, g, o] in registers and is bound by flops (2*4*nocc*nvir per vector
and grid point); see the source for its design.  A CPU tensor takes the
plain torch version below; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels import _cuda

NAME = "grid_rho1"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/grid_rho1.cu"
REPLACES = "xtddft_tpu/response/sigma_df.py:495"

launches = 0

_ARGS = [_cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.I, _cuda.P, _cuda.I, _cuda.I,
         _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P, _cuda.P]


def grid_rho1_plain(phi: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                    mask: torch.Tensor) -> torch.Tensor:
    """(nz, 4, gc): [rho1, d/dx, d/dy, d/dz] by the einsums of the JAX code."""
    nz, nocc, nvir = z.shape
    o = slice(o0, o0 + nocc)
    v = slice(v0, v0 + nvir)
    p0, p1 = phi[0], phi[1:4]
    tmp = torch.einsum("xov,gv->xgo", z, p0[:, v])
    r = torch.einsum("xgo,go->xg", tmp, p0[:, o])
    g = torch.einsum("xgo,ygo->xyg", tmp, p1[:, :, o])
    tmp2 = torch.einsum("xov,ygv->xygo", z, p1[:, :, v])
    g = g + torch.einsum("xygo,go->xyg", tmp2, p0[:, o])
    out = torch.cat([r[:, None], g], dim=1)
    return torch.where(mask != 0, out, torch.zeros((), dtype=out.dtype, device=out.device))


def grid_rho1(phi: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
              mask: torch.Tensor) -> torch.Tensor:
    """rho1[x, 0, g] = sum_ov z[x,o,v] phi0[g,o0+o] phi0[g,v0+v] and its
    gradient rho1[x, 1:4, g], zero where ``mask`` (gc,) is 0.

    phi: (4, gc, nmo) chunk of the MO grid table, any strides; z: (nz,
    nocc, nvir); mask: 0/1 in the working dtype."""
    global launches
    if phi.device.type == "cpu":
        return grid_rho1_plain(phi, z, o0, v0, mask)
    _cuda.require_cuda(NAME, phi, z, mask)
    nc4, gc, nmo = phi.shape
    nz, nocc, nvir = z.shape
    if nc4 != 4 or o0 + nocc > nmo or v0 + nvir > nmo or mask.shape != (gc,):
        raise ValueError(f"{NAME}: phi {tuple(phi.shape)}, z {tuple(z.shape)}, "
                         f"mask {tuple(mask.shape)}, o0={o0}, v0={v0} disagree")
    z = z.contiguous()
    mask = mask.contiguous()
    out = torch.zeros((nz, 4, gc), dtype=z.dtype, device=z.device)
    lib, fn = _cuda.entry(NAME, _ARGS, phi.dtype)
    rc = fn(phi.data_ptr(), *phi.stride(), gc, z.data_ptr(), nz, nocc, nvir,
            o0, v0, mask.data_ptr(), out.data_ptr(), _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    return out

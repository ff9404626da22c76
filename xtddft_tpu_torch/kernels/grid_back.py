"""K3: back-projection of the weighted fxc response to (occ, vir).

Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.back`
(:525-534).  The CUDA source (`csrc/grid_back.cu`) runs it as one GEMM on
the tile core of `csrc/gemm_tile.cuh` with M = nz*nocc, N = nvir and
K = 4 components x the points, forming the combined factors F in shared
memory as each tile of phi lands; the sigma calls it once per jvp group and
spin, on the group's whole point span.  It is bound by flops, at least
4*nz*nocc*nvir per grid point (`response/flops.py`); contracting over 4
components, it does twice that.  A CPU tensor takes
the plain torch version below; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels import _cuda

NAME = "grid_back"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/grid_back.cu"
REPLACES = "xtddft_tpu/response/sigma_df.py:525"

launches = 0

_ARGS = [_cuda.P, _cuda.P, _cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.I, _cuda.I,
         _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P]


def grid_back_plain(dwv: torch.Tensor, dwg: torch.Tensor, phi: torch.Tensor,
                    o0: int, v0: int, out: torch.Tensor) -> torch.Tensor:
    """out += r by the einsums of the JAX code; returns out."""
    nz, nocc, nvir = out.shape
    o = slice(o0, o0 + nocc)
    v = slice(v0, v0 + nvir)
    p0, p1 = phi[0], phi[1:4]
    tmp = torch.einsum("xg,go->xgo", dwv, p0[:, o])
    tmp = tmp + torch.einsum("xyg,ygo->xgo", dwg, p1[:, :, o])
    r = torch.einsum("xgo,gv->xov", tmp, p0[:, v])
    tmp2 = torch.einsum("xyg,go->xygo", dwg, p0[:, o])
    r = r + torch.einsum("xygo,ygv->xov", tmp2, p1[:, :, v])
    out += r
    return out


def grid_back(dwv: torch.Tensor, dwg: torch.Tensor, phi: torch.Tensor,
              o0: int, v0: int, out: torch.Tensor) -> torch.Tensor:
    """out[x,o,v] += sum_g (dwv phi0_o + sum_y dwg_y phiy_o) phi0_v
    + sum_g sum_y dwg_y phi0_o phiy_v, with phi_o = phi[:, :, o0+o] and
    phi_v = phi[:, :, v0+v]; returns out.

    dwv: (nz, gc); dwg: (nz, 3, gc); phi: (4, gc, nmo) span of gc grid
    points, any strides; out: (nz, nocc, nvir) contiguous accumulator."""
    global launches
    if phi.device.type == "cpu":
        return grid_back_plain(dwv, dwg, phi, o0, v0, out)
    _cuda.require_cuda(NAME, phi, dwv, dwg, out)
    nc4, gc, nmo = phi.shape
    nz, nocc, nvir = out.shape
    if (nc4 != 4 or dwv.shape != (nz, gc) or dwg.shape != (nz, 3, gc)
            or o0 + nocc > nmo or v0 + nvir > nmo or not out.is_contiguous()):
        raise ValueError(f"{NAME}: phi {tuple(phi.shape)}, dwv {tuple(dwv.shape)}, "
                         f"dwg {tuple(dwg.shape)}, out {tuple(out.shape)} disagree")
    dwv = dwv.contiguous()
    dwg = dwg.contiguous()
    lib, fn = _cuda.entry(NAME, _ARGS, phi.dtype)
    rc = fn(dwv.data_ptr(), dwg.data_ptr(), phi.data_ptr(), *phi.stride(), gc,
            nz, nocc, nvir, o0, v0, out.data_ptr(), _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    return out

"""K1: density-fitted exchange of the X-TDA sigma for one spin block.

Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._jk` (:399-433).
The CUDA kernel (`csrc/df_exchange.cu`) keeps the half-transform T of each
aux index on chip and is bound by flops (2*naux*nocc*nvir^2 per trial
vector); see the source for its design.  A CPU tensor takes the plain
torch version below; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels import _cuda

NAME = "df_exchange"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/df_exchange.cu"
REPLACES = "xtddft_tpu/response/sigma_df.py:399"
MAX_NOCC = 256  # the kernel keeps ceil(nocc/16) <= 16 rows per thread in registers

launches = 0

_ARGS = [_cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.I, _cuda.P, _cuda.I, _cuda.I,
         _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P, _cuda.P]


def df_exchange_plain(B: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                      chunk: int | None = None):
    """(t (nz, naux), K (nz, nocc, nvir)) by the einsums of the JAX code,
    aux-chunked by ``chunk`` rows (default: all of naux)."""
    naux = B.shape[0]
    nz, nocc, nvir = z.shape
    o = slice(o0, o0 + nocc)
    v = slice(v0, v0 + nvir)
    chunk = naux if chunk is None else chunk
    K = torch.zeros((nz, nocc, nvir), dtype=z.dtype, device=z.device)
    t = torch.empty((nz, naux), dtype=z.dtype, device=z.device)
    for p0 in range(0, naux, chunk):
        Bc = B[p0:p0 + chunk]
        t[:, p0:p0 + chunk] = torch.einsum("Pjb,xjb->xP", Bc[:, o, v], z)
        T = torch.einsum("Pab,xjb->xPja", Bc[:, v, v], z)
        K += torch.einsum("Pji,xPja->xia", Bc[:, o, o], T)
    return t, K


def df_exchange(B: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                chunk: int | None = None):
    """t[x,P] = sum_jb B[P,o0+j,v0+b] z[x,j,b] and
    K[x,i,a] = sum_{P,j,b} B[P,o0+j,o0+i] B[P,v0+a,v0+b] z[x,j,b].

    B: (naux, nmo, nmo), any strides; z: (nz, nocc, nvir).  ``chunk`` only
    bounds the plain version's intermediate."""
    global launches
    if B.device.type == "cpu":
        return df_exchange_plain(B, z, o0, v0, chunk)
    _cuda.require_cuda(NAME, B, z)
    naux, nmo, nmo2 = B.shape
    nz, nocc, nvir = z.shape
    if nmo != nmo2 or o0 + nocc > nmo or v0 + nvir > nmo:
        raise ValueError(f"{NAME}: B {tuple(B.shape)} does not hold o0={o0}, "
                         f"v0={v0} and z {tuple(z.shape)}")
    if nocc > MAX_NOCC:
        raise ValueError(f"{NAME}: nocc={nocc} above the kernel's {MAX_NOCC}")
    z = z.contiguous()
    t = torch.empty((nz, naux), dtype=z.dtype, device=z.device)
    K = torch.zeros((nz, nocc, nvir), dtype=z.dtype, device=z.device)
    lib, fn = _cuda.entry(NAME, _ARGS, B.dtype)
    rc = fn(B.data_ptr(), *B.stride(), naux, z.data_ptr(), nz, nocc, nvir,
            o0, v0, t.data_ptr(), K.data_ptr(), _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    return t, K

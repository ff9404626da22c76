"""K1: density-fitted exchange of a sigma build for one block of trial vectors.

Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._jk` (:399-433)
and the spin-flip exchange `sf_sigma_df._k` (:821) / `xsf_sigma_df._k`
(:1066): there the virtual panel may come from a second tensor (``B_vir``:
the other spin's MO transform), the o and v ranges may overlap, and there is
no Coulomb term (``with_t=False``).  `rpa_exchange` is the RPA B matrix's
exchange, `xtda_sigma_df._k2` (:459-477), on the same two stages with other
row and column ranges of B, in the cheaper of two contraction orders.  The
CUDA source (`csrc/df_exchange.cu`) runs it as two GEMMs on the tile
core of `csrc/gemm_tile.cuh` (f64 on the DMMA tensor cores, f32 as
register-tiled FMA, `cp.async` staging) through a half-transform buffer T
that this wrapper allocates once per call, one aux chunk at a time, plus a
reduction kernel for the Coulomb intermediate t.  It is bound by flops,
2*naux*nz*nocc*nvir*(nvir+nocc+1), one less in the bracket without t
(`response/flops.py`).  The split-K partials of K are summed in a fixed
order through a workspace, so that the same inputs give the bitwise-same t
and K on every launch (the SCF's convergence test sits at the rounding of
its Fock build).  A CPU tensor
takes the plain torch version below; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.kernels import _cuda

NAME = "df_exchange"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/df_exchange.cu"
REPLACES = "xtddft_tpu/response/sigma_df.py:399"
T_BUDGET_BYTES = 1 << 30  # the kernel's T buffer per call

launches = 0
# launches by mode, counted with ``launches``: the exchange-only mode (a flip
# block's K, an RSH's long-range pass, the SCF's long-range K) and the RPA
# exchange (the B half of a TDHF sigma)
mode_launches = {"exchange_only": 0, "rpa_exchange": 0}

_ARGS = [_cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.P, _cuda.L, _cuda.L, _cuda.L, _cuda.I,
         _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
         _cuda.I, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.P, _cuda.L, _cuda.P]
# the C entry's modes
EXCHANGE, RPA_OV, RPA_VO = 0, 1, 2


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_aux_chunk(naux: int, nz: int, nocc: int, nvir: int, itemsize: int,
                   budget: int = T_BUDGET_BYTES) -> int:
    """Aux indices per T chunk: the most whose T (chunk*nocc rows of nz*nvir
    elements, padded to 16 bytes) fits ``budget`` bytes, evened out over the
    chunks; at least 1.  The kernel walks [P0, P0 + chunk) for P0 = 0,
    chunk, 2*chunk, ... below naux."""
    per_aux = nocc * _round_up(nz * nvir, 16 // itemsize) * itemsize
    most = max(1, min(naux, budget // per_aux))
    nchunks = -(-naux // most)
    return -(-naux // nchunks)


def df_exchange_plain(B: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                      chunk: int | None = None, B_vir: torch.Tensor | None = None,
                      with_t: bool = True):
    """(t (nz, naux) or None, K (nz, nocc, nvir)) by the einsums of the JAX
    code, aux-chunked by ``chunk`` rows (default: ``plan_aux_chunk``'s)."""
    naux = B.shape[0]
    nz, nocc, nvir = z.shape
    Bv = B if B_vir is None else B_vir
    o = slice(o0, o0 + nocc)
    v = slice(v0, v0 + nvir)
    if chunk is None:
        chunk = plan_aux_chunk(naux, nz, nocc, nvir, z.element_size())
    K = torch.zeros((nz, nocc, nvir), dtype=z.dtype, device=z.device)
    t = torch.empty((nz, naux), dtype=z.dtype, device=z.device) if with_t else None
    for p0 in range(0, naux, chunk):
        Bc = B[p0:p0 + chunk]
        if with_t:
            t[:, p0:p0 + chunk] = torch.einsum("Pjb,xjb->xP", Bc[:, o, v], z)
        T = torch.einsum("Pab,xjb->xPja", Bv[p0:p0 + chunk, v, v], z)
        K += torch.einsum("Pji,xPja->xia", Bc[:, o, o], T)
    return t, K


def df_exchange(B: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                chunk: int | None = None, B_vir: torch.Tensor | None = None,
                with_t: bool = True):
    """t[x,P] = sum_jb B[P,o0+j,v0+b] z[x,j,b] (None unless ``with_t``) and
    K[x,i,a] = sum_{P,j,b} B[P,o0+j,o0+i] B_vir[P,v0+a,v0+b] z[x,j,b].

    B, B_vir (default B): (naux, nmo, nmo), any strides; z: (nz, nocc, nvir).
    The occupied block is read as B[P, j, i] where the JAX flip code writes
    B[P, i, j]: the same number, because a fitted MO tensor is symmetric in
    its MO pair (the beta transform of a UKS reference too).  ``chunk``: aux
    indices per T intermediate, for the kernel and the plain version alike
    (default: ``plan_aux_chunk``'s, from ``T_BUDGET_BYTES``).  The Coulomb
    intermediate is defined within one spin's tensor, so a second tensor
    goes with ``with_t=False`` only.  Bitwise repeatable on the card, as the
    plain version on the CPU is."""
    if B_vir is not None and with_t:
        raise ValueError(f"{NAME}: a second tensor (B_vir) has no Coulomb term; "
                         "pass with_t=False")
    if min(*z.shape, B.shape[0]) < 1:
        raise ValueError(f"{NAME}: empty extent in z {tuple(z.shape)}, naux {B.shape[0]}")
    if chunk is None:
        chunk = plan_aux_chunk(B.shape[0], *z.shape, z.element_size())
    if chunk < 1:
        raise ValueError(f"{NAME}: aux chunk {chunk} < 1")
    if B.device.type == "cpu":
        return df_exchange_plain(B, z, o0, v0, chunk, B_vir, with_t)
    t, K = _launch(B, B if B_vir is None else B_vir, z, o0, v0, EXCHANGE, chunk, with_t)
    if not with_t:
        mode_launches["exchange_only"] += 1
    return t, K


def rpa_order(nocc: int, nvir: int) -> int:
    """The cheaper contraction order of the RPA exchange: RPA_OV (T over
    (j, x, i), 4*naux*nz*nocc^2*nvir flops) when nocc < nvir, else RPA_VO
    (the JAX order, T over (b, x, a), 4*naux*nz*nocc*nvir^2)."""
    return RPA_OV if nocc < nvir else RPA_VO


def rpa_exchange_plain(B: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                       chunk: int | None = None) -> torch.Tensor:
    """v (nz, nocc, nvir) by einsums in the order `rpa_order` picks (RPA_VO:
    the JAX `_k2` pair), aux-chunked by ``chunk`` rows (default:
    ``plan_aux_chunk``'s for that order's T)."""
    naux = B.shape[0]
    nz, nocc, nvir = z.shape
    ov = rpa_order(nocc, nvir) == RPA_OV
    if chunk is None:
        n = nocc if ov else nvir
        chunk = plan_aux_chunk(naux, nz, n, n, z.element_size())
    v = torch.zeros((nz, nocc, nvir), dtype=z.dtype, device=z.device)
    for p0 in range(0, naux, chunk):
        Bov = B[p0:p0 + chunk, o0:o0 + nocc, v0:v0 + nvir]
        if ov:
            T = torch.einsum("Pib,xjb->xPji", Bov, z)
            v += torch.einsum("Pja,xPji->xia", Bov, T)
        else:
            T = torch.einsum("Pja,xjb->xPab", Bov, z)
            v += torch.einsum("Pib,xPab->xia", Bov, T)
    return v


def rpa_exchange(B: torch.Tensor, z: torch.Tensor, o0: int, v0: int,
                 chunk: int | None = None) -> torch.Tensor:
    """v[x,i,a] = sum_{P,j,b} B[P,o0+i,v0+b] B[P,o0+j,v0+a] z[x,j,b]: the
    exchange (ib|ja) z_jb of the RPA B matrix on one spin's tensor.

    B: (naux, nmo, nmo), any strides, symmetric in its MO pair (a fitted MO
    tensor is); z: (nz, nocc, nvir).  The order is `rpa_order`'s; ``chunk``:
    aux indices per T intermediate, for the kernel and the plain version
    alike (default: ``plan_aux_chunk``'s for that order).  Counted in
    ``launches`` and ``mode_launches["rpa_exchange"]``.  Bitwise repeatable
    on the card."""
    if min(*z.shape, B.shape[0]) < 1:
        raise ValueError(f"{NAME}: empty extent in z {tuple(z.shape)}, naux {B.shape[0]}")
    nz, nocc, nvir = z.shape
    mode = rpa_order(nocc, nvir)
    if chunk is None:
        n = nocc if mode == RPA_OV else nvir
        chunk = plan_aux_chunk(B.shape[0], nz, n, n, z.element_size())
    if chunk < 1:
        raise ValueError(f"{NAME}: aux chunk {chunk} < 1")
    if B.device.type == "cpu":
        return rpa_exchange_plain(B, z, o0, v0, chunk)
    _, v = _launch(B, B, z, o0, v0, mode, chunk, False)
    mode_launches["rpa_exchange"] += 1
    return v


def _launch(B, Bv, z, o0, v0, mode, chunk, with_t):
    """One launch of the C entry in ``mode``; returns (t or None, K).
    Stage A's trial vectors go in transposed, zT[shift + k][x*J + j], with
    (J, k) = (nocc, b) for EXCHANGE and RPA_OV and (nvir, j) for RPA_VO."""
    global launches
    _cuda.require_cuda(NAME, B, Bv, z)
    naux, nmo, nmo2 = B.shape
    nz, nocc, nvir = z.shape
    if nmo != nmo2 or Bv.shape != B.shape or o0 + nocc > nmo or v0 + nvir > nmo:
        raise ValueError(f"{NAME}: B {tuple(B.shape)}, B_vir {tuple(Bv.shape)} do not hold "
                         f"o0={o0}, v0={v0} and z {tuple(z.shape)}")
    chunk = min(chunk, naux)
    z = z.contiguous()
    t = torch.empty((nz, naux), dtype=z.dtype, device=z.device) if with_t else None
    K = torch.zeros((nz, nocc, nvir), dtype=z.dtype, device=z.device)
    # The half-transform reads Bv's rows from column c0 - shift (c0 = v0,
    # o0 for RPA_VO), shift = c0 mod the 16-byte run width (so that the runs
    # start aligned where the strides allow them); z goes in transposed, with
    # zero rows before the first real k and rows padded to a run.  The
    # columns before c0 are padding of the block or, where ranges overlap,
    # live columns of another block: the zero rows cancel both.
    vec = 16 // z.element_size()
    if mode == RPA_VO:
        c0, J, na, zk = o0, nvir, nvir, z.permute(1, 0, 2).reshape(nocc, nz * nvir)
    else:
        c0, J, na = v0, nocc, (nocc if mode == RPA_OV else nvir)
        zk = z.reshape(nz * nocc, nvir).T
    shift = c0 % vec
    ldz = _round_up(nz * J, vec)
    zT = torch.zeros((shift + zk.shape[0], ldz), dtype=z.dtype, device=z.device)
    zT[shift:, :nz * J] = zk
    npad = _round_up(nz * na, vec)
    Tb = torch.empty(chunk * J * npad, dtype=z.dtype, device=z.device)
    W = _cuda.workspace(K.numel(), K)
    lib, fn = _cuda.entry(NAME, _ARGS, B.dtype)
    rc = fn(B.data_ptr(), *B.stride(), Bv.data_ptr(), *Bv.stride(), naux, z.data_ptr(),
            zT.data_ptr(), ldz, shift, nz, nocc, nvir, o0, v0, mode,
            t.data_ptr() if with_t else None, K.data_ptr(), Tb.data_ptr(), npad,
            chunk, W.data_ptr(), W.numel(),
            _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    return t, K

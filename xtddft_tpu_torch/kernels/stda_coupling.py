"""K4: the Coulomb-type coupling block of the simplified TDA.

Replaces `xtddft_tpu/stda/core.py` `_j_block` (:294-311), J[p,q] =
sum_A g[A, o_row[p], o_col[q]] qv[A, v_row[p], v_col[q]] over two CSF lists
of one spin, and the Coulomb diagonal of `csf_diagonal` (:323), the same
with the row list on both sides.  The CUDA source (`csrc/stda_coupling.cu`)
gives each block a tile of J and its index lists in shared memory and reads
the two small tables in their (A, row, column) layout, so that nothing of
size (atoms, rows, columns) is formed, as the JAX gathers form it; it can
subtract the block from a strided view in place (a spin block of the
coupling matrix).  The CSF lists are `CSFList`s: int32 index tensors on
the tables' device, made and range-checked once per CSF set (`csf_list`),
so that a call moves no index list across the bus.  It is bound by the write
of J (`response/flops.py` ``stda_j_bytes``).  A CPU tensor takes the plain
torch version below (the JAX gathers, 2048 rows at a time); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from xtddft_tpu_torch.kernels import _cuda

NAME = "stda_coupling"
ROUTE = "cuda"
SOURCE = "xtddft_tpu_torch/csrc/stda_coupling.cu"
REPLACES = "xtddft_tpu/stda/core.py:294"
PLAIN_ROWS = 2048  # the plain version's row chunk (the JAX code's)

launches = 0
# launches by mode, counted with ``launches``: the diagonal (csf_diagonal)
mode_launches = {"diagonal": 0}

_ARGS = [_cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P, _cuda.I, _cuda.P,
         _cuda.P, _cuda.I, _cuda.P, _cuda.L, _cuda.I, _cuda.I, _cuda.P]


@dataclasses.dataclass(frozen=True)
class CSFList:
    """The (occupied, virtual) indices of a list of same-spin CSFs as K4
    reads them: int32 tensors on one device whose ranges [0, nocc) and
    [0, nvir) were checked when they were made (`csf_list`)."""

    occ: torch.Tensor
    vir: torch.Tensor
    nocc: int
    nvir: int

    def __len__(self) -> int:
        return int(self.occ.shape[0])


def csf_list(occ, vir, nocc: int, nvir: int, device) -> CSFList:
    """Upload host index arrays once and check their ranges on ``device``
    (one host read of the verdict); raises ValueError where an index lies
    outside [0, nocc) or [0, nvir) or the lists differ in length."""
    occ, vir = (np.asarray(i, dtype=np.int64).reshape(-1) for i in (occ, vir))
    if occ.shape != vir.shape:
        raise ValueError(f"{NAME}: occupied and virtual lists of unequal length "
                         f"({occ.size}, {vir.size})")
    o, v = (torch.as_tensor(i, device=device) for i in (occ, vir))
    if o.numel() and bool(((o < 0) | (o >= nocc)).any() | ((v < 0) | (v >= nvir)).any()):
        raise ValueError(f"{NAME}: a CSF index outside [0, {nocc}) x [0, {nvir})")
    return CSFList(o.to(torch.int32), v.to(torch.int32), int(nocc), int(nvir))


def _check(g, qv, *lists):
    natm, nocc, nocc2 = g.shape
    if nocc != nocc2 or qv.dim() != 3 or qv.shape[0] != natm or qv.shape[1] != qv.shape[2]:
        raise ValueError(f"{NAME}: tables {tuple(g.shape)} and {tuple(qv.shape)}")
    for lst in lists:
        if not isinstance(lst, CSFList):
            raise TypeError(f"{NAME}: index lists go in as CSFList (see csf_list), "
                            f"got {type(lst).__name__}")
        if (lst.nocc, lst.nvir) != (nocc, qv.shape[1]) or lst.occ.device != g.device:
            raise ValueError(f"{NAME}: a list checked against ({lst.nocc}, {lst.nvir}) on "
                             f"{lst.occ.device} for tables of ({nocc}, {qv.shape[1]}) on "
                             f"{g.device}")


def j_block_plain(g, qv, rows: CSFList, cols: CSFList, chunk: int = PLAIN_ROWS):
    """J (nrow, ncol) by the JAX gather einsum, ``chunk`` rows at a time."""
    o_row, v_row, o_col, v_col = (i.long() for i in (rows.occ, rows.vir, cols.occ, cols.vir))
    out = [torch.einsum("Arq,Arq->rq", g[:, o_row[s:s + chunk]][:, :, o_col],
                        qv[:, v_row[s:s + chunk]][:, :, v_col])
           for s in range(0, o_row.shape[0], chunk)]
    if not out:
        return torch.zeros((0, len(cols)), dtype=g.dtype, device=g.device)
    return torch.cat(out, dim=0)


def j_diagonal_plain(g, qv, lst: CSFList):
    """J[p] = sum_A g[A, o[p], o[p]] qv[A, v[p], v[p]]."""
    o, v = lst.occ.long(), lst.vir.long()
    return torch.einsum("Ap,Ap->p", g[:, o, o], qv[:, v, v])


def _launch(g, qv, rows, cols, J, sub, diagonal: bool):
    global launches
    _cuda.require_cuda(NAME, g, qv, J)
    g, qv = g.contiguous(), qv.contiguous()
    natm, nocc, _ = g.shape
    lib, fn = _cuda.entry(NAME, _ARGS, g.dtype)
    rc = fn(g.data_ptr(), qv.data_ptr(), natm, nocc, qv.shape[1], rows.occ.data_ptr(),
            rows.vir.data_ptr(), len(rows), None if diagonal else cols.occ.data_ptr(),
            None if diagonal else cols.vir.data_ptr(), len(rows) if diagonal else len(cols),
            J.data_ptr(), 1 if diagonal else J.stride(0), int(sub), int(diagonal),
            _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    if diagonal:
        mode_launches["diagonal"] += 1
    return J


def j_block(g: torch.Tensor, qv: torch.Tensor, rows: CSFList, cols: CSFList,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """J[p, q] = sum_A g[A, o_row[p], o_col[q]] qv[A, v_row[p], v_col[q]].

    g: (natm, nocc, nocc), qv: (natm, nvir, nvir) on one device; ``rows``
    and ``cols`` `CSFList`s of those extents on that device (repeats
    allowed).  ``out``: a (nrow, ncol) view with unit column stride (a spin
    block of the coupling matrix) from which J is subtracted in place and
    which is returned; else J is returned.  An empty list launches nothing.
    Bitwise repeatable on the card."""
    _check(g, qv, rows, cols)
    shape = (len(rows), len(cols))
    if out is not None and (tuple(out.shape) != shape or out.dtype != g.dtype
                            or out.device != g.device or (out.numel() and out.stride(1) != 1)):
        raise ValueError(f"{NAME}: out {tuple(out.shape)} {out.dtype} on {out.device} with "
                         f"strides {out.stride()} for a {shape} block")
    if not (len(rows) and len(cols)):
        return torch.zeros(shape, dtype=g.dtype, device=g.device) if out is None else out
    if g.device.type == "cpu":
        J = j_block_plain(g, qv, rows, cols)
        return J if out is None else out.sub_(J)
    if out is None:
        return _launch(g, qv, rows, cols, torch.empty(shape, dtype=g.dtype, device=g.device),
                       False, False)
    return _launch(g, qv, rows, cols, out, True, False)


def j_diagonal(g: torch.Tensor, qv: torch.Tensor, lst: CSFList) -> torch.Tensor:
    """J[p] = sum_A g[A, o[p], o[p]] qv[A, v[p], v[p]] (the diagonal of
    `j_block` on one list), counted in ``mode_launches["diagonal"]``."""
    _check(g, qv, lst)
    if not len(lst):
        return torch.zeros((0,), dtype=g.dtype, device=g.device)
    if g.device.type == "cpu":
        return j_diagonal_plain(g, qv, lst)
    return _launch(g, qv, lst, None, torch.empty((len(lst),), dtype=g.dtype, device=g.device),
                   False, True)

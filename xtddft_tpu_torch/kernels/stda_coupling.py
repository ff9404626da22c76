"""K4: the Coulomb-type coupling block of the simplified TDA.

Replaces `xtddft_tpu/stda/core.py` `_j_block` (:294-311), J[p,q] =
sum_A g[A, o_row[p], o_col[q]] qv[A, v_row[p], v_col[q]] over two CSF lists
of one spin, and the Coulomb diagonal of `csf_diagonal` (:323), the same
with the row lists on both sides.  The CUDA source (`csrc/stda_coupling.cu`)
gives each block a tile of J and its index lists in shared memory and reads
the two small tables in their (A, row, column) layout, so that nothing of
size (atoms, rows, columns) is formed, as the JAX gathers form it.  It is
bound by the write of J (`response/flops.py` ``stda_j_bytes``).  A CPU
tensor takes the plain torch version below (the JAX gathers, 2048 rows at a
time); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

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
         _cuda.P, _cuda.I, _cuda.P, _cuda.I, _cuda.P]


def _check(g, qv, lists):
    natm, nocc, nocc2 = g.shape
    if nocc != nocc2 or qv.dim() != 3 or qv.shape[0] != natm or qv.shape[1] != qv.shape[2]:
        raise ValueError(f"{NAME}: tables {tuple(g.shape)} and {tuple(qv.shape)}")
    for (name, idx), n in zip(lists.items(), (nocc, qv.shape[1]) * 2):
        idx = np.asarray(idx)
        if idx.ndim != 1 or (idx.size and (idx.min() < 0 or idx.max() >= n)):
            raise ValueError(f"{NAME}: {name} out of range [0, {n})")


def j_block_plain(g, qv, o_row, v_row, o_col, v_col, chunk: int = PLAIN_ROWS):
    """J (nrow, ncol) by the JAX gather einsum, ``chunk`` rows at a time."""
    dev = g.device
    o_row, v_row, o_col, v_col = (torch.as_tensor(np.asarray(i), dtype=torch.long, device=dev)
                                  for i in (o_row, v_row, o_col, v_col))
    out = [torch.einsum("Arq,Arq->rq", g[:, o_row[s:s + chunk]][:, :, o_col],
                        qv[:, v_row[s:s + chunk]][:, :, v_col])
           for s in range(0, o_row.shape[0], chunk)]
    if not out:
        return torch.zeros((0, o_col.shape[0]), dtype=g.dtype, device=dev)
    return torch.cat(out, dim=0)


def j_diagonal_plain(g, qv, o, v):
    """J[p] = sum_A g[A, o[p], o[p]] qv[A, v[p], v[p]]."""
    o = torch.as_tensor(np.asarray(o), dtype=torch.long, device=g.device)
    v = torch.as_tensor(np.asarray(v), dtype=torch.long, device=g.device)
    return torch.einsum("Ap,Ap->p", g[:, o, o], qv[:, v, v])


def _launch(g, qv, o_row, v_row, o_col, v_col, diagonal: bool):
    global launches
    _cuda.require_cuda(NAME, g, qv)
    g, qv = g.contiguous(), qv.contiguous()
    natm, nocc, _ = g.shape
    nvir = qv.shape[1]
    nrow = len(o_row)
    ncol = nrow if diagonal else len(o_col)

    def dev(i):
        return torch.as_tensor(np.asarray(i), dtype=torch.int32, device=g.device)

    lists = [dev(i) for i in (o_row, v_row)] + ([] if diagonal else [dev(i) for i in
                                                                     (o_col, v_col)])
    J = torch.empty((nrow,) if diagonal else (nrow, ncol), dtype=g.dtype, device=g.device)
    lib, fn = _cuda.entry(NAME, _ARGS, g.dtype)
    rc = fn(g.data_ptr(), qv.data_ptr(), natm, nocc, nvir, lists[0].data_ptr(),
            lists[1].data_ptr(), nrow, None if diagonal else lists[2].data_ptr(),
            None if diagonal else lists[3].data_ptr(), ncol, J.data_ptr(), int(diagonal),
            _cuda.stream())
    _cuda.check(lib, NAME, rc)
    launches += 1
    if diagonal:
        mode_launches["diagonal"] += 1
    return J


def j_block(g: torch.Tensor, qv: torch.Tensor, o_row, v_row, o_col, v_col) -> torch.Tensor:
    """J[p, q] = sum_A g[A, o_row[p], o_col[q]] qv[A, v_row[p], v_col[q]].

    g: (natm, nocc, nocc), qv: (natm, nvir, nvir) on one device; the four
    index lists host integer arrays (rows: o_row, v_row; columns: o_col,
    v_col), repeats allowed.  An empty list gives an empty J and no launch.
    Bitwise repeatable on the card."""
    _check(g, qv, {"o_row": o_row, "v_row": v_row, "o_col": o_col, "v_col": v_col})
    if len(o_row) != len(v_row) or len(o_col) != len(v_col):
        raise ValueError(f"{NAME}: row or column lists of unequal length")
    if len(o_row) == 0 or len(o_col) == 0:
        return torch.zeros((len(o_row), len(o_col)), dtype=g.dtype, device=g.device)
    if g.device.type == "cpu":
        return j_block_plain(g, qv, o_row, v_row, o_col, v_col)
    return _launch(g, qv, o_row, v_row, o_col, v_col, diagonal=False)


def j_diagonal(g: torch.Tensor, qv: torch.Tensor, o, v) -> torch.Tensor:
    """J[p] = sum_A g[A, o[p], o[p]] qv[A, v[p], v[p]] (the diagonal of
    `j_block` on one list), counted in ``mode_launches["diagonal"]``."""
    _check(g, qv, {"o": o, "v": v})
    if len(o) != len(v):
        raise ValueError(f"{NAME}: index lists of unequal length")
    if len(o) == 0:
        return torch.zeros((0,), dtype=g.dtype, device=g.device)
    if g.device.type == "cpu":
        return j_diagonal_plain(g, qv, o, v)
    return _launch(g, qv, o, v, None, None, diagonal=True)

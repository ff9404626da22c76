"""State irrep labels for excitation results.

Each excited state is labeled with the direct product of the dominant
occupied/virtual MO irreps (PySCF's ``symm`` route in the original code).
Here the group and characters come from `chem/symmetry.py` and the blocked
excitation layouts supply the (occ, vir) pair map.  A copy of the JAX
package's `props/irreps.py` (host numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.chem.symmetry import analyze, mo_irreps, product_label

__all__ = ["state_irreps", "pairs_spin_conserving", "pairs_spin_flip"]


def pairs_spin_conserving(nc: int, no: int, nv: int) -> np.ndarray:
    """(dim, 2) (occ_mo, vir_mo) per row of the CV(a)|OV(a)|CO(b)|CV(b)
    blocked layout (MO indices into the shared spatial set)."""
    rows = []
    c = range(nc)
    o = range(nc, nc + no)
    v = range(nc + no, nc + no + nv)
    for i in c:
        rows += [(i, a) for a in v]          # CV(alpha)
    for i in o:
        rows += [(i, a) for a in v]          # OV(alpha)
    for i in c:
        rows += [(i, a) for a in o]          # CO(beta)
    for i in c:
        rows += [(i, a) for a in v]          # CV(beta)
    return np.asarray(rows)


def pairs_spin_flip(nc: int, no: int, nv: int) -> np.ndarray:
    """(dim, 2) pair map of the spin-flip-down CV|CO|OV|OO layout."""
    rows = []
    c = range(nc)
    o = range(nc, nc + no)
    v = range(nc + no, nc + no + nv)
    for i in c:
        rows += [(i, a) for a in v]
    for i in c:
        rows += [(i, a) for a in o]
    for i in o:
        rows += [(i, a) for a in v]
    for i in o:
        rows += [(i, a) for a in o]
    return np.asarray(rows)


def state_irreps(ref, vectors: np.ndarray, kind: str = "spin_conserving",
                 tol_dominant: float = 0.1):
    """Irrep label per state column of ``vectors`` (blocked layout).

    Returns (labels, group_name).  States whose significant amplitudes
    disagree on the product irrep — or that sit on symmetry-broken MOs —
    get '?', mirroring the reference's behavior of only labeling clean
    states."""
    nc, no, nv = ref.nc, ref.no, ref.nv
    pairs = (pairs_spin_conserving if kind == "spin_conserving"
             else pairs_spin_flip)(nc, no, nv)
    info = analyze(ref.env.mol)
    labels, chars = mo_irreps(
        ref.env.layout, ref.env.S.detach().to("cpu", torch.float64).numpy(),
        np.asarray(ref.mo_a), info,
        mo_energy=np.diag(np.asarray(ref.fock_a_mo)),
    )
    V = np.asarray(vectors)
    if V.shape[0] != pairs.shape[0]:
        raise ValueError(
            f"vector dim {V.shape[0]} != layout dim {pairs.shape[0]}")
    out = []
    for s in range(V.shape[1]):
        v = V[:, s]
        idx = np.where(np.abs(v) > tol_dominant * np.abs(v).max())[0]
        labs = set()
        for row in idx:
            o, a = pairs[row]
            if labels[o] == "?" or labels[a] == "?":
                labs.add("?")
            else:
                labs.add(product_label(info, chars[o], chars[a]))
        out.append(labs.pop() if len(labs) == 1 else "?")
    return out, info.group

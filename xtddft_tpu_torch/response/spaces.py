"""Excitation-space block layouts and basis rotations (host numpy).

Counterpart of the JAX package's `response/spaces.py`: the CV/OV/CO/CV
(spin-conserving) and CV/CO/OV/OO (spin-flip) block conventions.
"""

from __future__ import annotations

import numpy as np


def order_interleaved2blocked(nc: int, no: int, nv: int) -> np.ndarray:
    """Permutation from the 'pyscf' vector layout (alpha ov-pairs then beta
    ov-pairs, each row-major over (occ, vir)) to the blocked layout
    CV(a) | OV(a) | CO(b) | CV(b).

    Equivalent to `utils.order_pyscf2my` (`xtddft/utils/utils.py:44-64`).
    The alpha part is already blocked (CV then OV); the beta part interleaves
    each occupied row's O and V columns, which this permutation separates.
    """
    dim = (nc + no) * nv + nc * (no + nv)
    order = np.arange(dim)
    off = (nc + no) * nv
    beta = order[off:].reshape(nc, no + nv)
    co = beta[:, :no].reshape(-1)
    cv = beta[:, no:].reshape(-1)
    return np.concatenate([order[:off], co, cv])


def so2st(v: np.ndarray, nc: int, no: int, nv: int) -> np.ndarray:
    """Spin-orbital -> spin-tensor rotation of blocked eigenvectors
    (cv0 = (cva+cvb)/sqrt2, cv1 = (cva-cvb)/sqrt2), `utils/utils.py:67-94`."""
    cva = v[: nc * nv]
    ova = v[nc * nv : (nc + no) * nv]
    cob = v[(nc + no) * nv : (nc + no) * nv + nc * no]
    cvb = v[(nc + no) * nv + nc * no :]
    s = np.sqrt(2.0) / 2.0
    return np.concatenate([s * (cva + cvb), ova, cob, s * (cva - cvb)], axis=0)


def st2so(v: np.ndarray, nc: int, no: int, nv: int) -> np.ndarray:
    cv0 = v[: nc * nv]
    ov0 = v[nc * nv : (nc + no) * nv]
    co0 = v[(nc + no) * nv : (nc + no) * nv + nc * no]
    cv1 = v[(nc + no) * nv + nc * no :]
    s = 1.0 / np.sqrt(2.0)
    return np.concatenate([s * (cv0 + cv1), ov0, co0, s * (cv0 - cv1)], axis=0)


def sf_oo_projector(no: int) -> np.ndarray:
    """(no^2, no^2-1) orthonormal basis of the OO block with the traceful
    Sf=Si contaminant direction removed (`xtddft/XSF_TDA.py:397-414`)."""
    tmp_v = np.zeros((no - 1, no))
    for i in range(1, no):
        factor = 1.0 / np.sqrt((no - i + 1) * (no - i))
        row = np.array([no - i] + [-1.0] * (no - i))
        tmp_v[i - 1, i - 1 :] = row * factor
    vect = tmp_v.T  # (no, no-1)
    vects = np.eye(no * no)[:, :-1]
    index = [0] + [i * (no + 1) for i in range(1, no)]
    for i in range(vect.shape[1]):
        vects[0 :: no + 1, index[i]] = vect[:, i]
    return vects

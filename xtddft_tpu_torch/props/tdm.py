"""Spin-tensor transition-density contractions <Psi_L|E_pq|Psi_R> for all
state-pair cases of the SOC-SI layer (host numpy).

Counterpart of the JAX package's `props/tdm.py`: the case tables of the
reference's `x2c_hamiltonian/driver/tdm.py` (cases 1-31 of the paper's
numbering).  States are lists of reshaped CI blocks:

- ``S-`` manifold (spin S-1): [CV1 (nc,nv), CO1 (nc,no), OV1 (no,nv),
  O1O2 (no,no), O1O1 (no,)]
- ``S``  manifold (spin S):   [CV0, CO0, OV0, CV1] (CV1 absent for S=0)
- ``S+`` manifold (spin S+1): [CV1]

``ints`` is any one-electron MO operator stacked (3, nmo, nmo); orbitals
are in core|open|virtual order.
"""

from __future__ import annotations

import numpy as np

_SQ2 = np.sqrt(2.0)


def _slices(n):
    nc, no, nv = n
    return (
        slice(0, nc),
        slice(nc, nc + no),
        slice(nc + no, None),
    )


def tdm_gsgs(S, XL, XR, ints, n):
    return np.zeros(3)


def tdm_gss(S, XL, XR, ints, n):
    """<GS|O|Psi(S)>, cases 17-20 (`driver/tdm.py:14-42`)."""
    slc, slo, slv = _slices(n)
    tdm = _SQ2 * np.einsum("xbj,jb->x", ints[:, slv, slc], XR[0])
    if S != 0:
        tdm += np.einsum("xjt,jt->x", ints[:, slc, slo], XR[1])
        tdm += np.einsum("xtb,tb->x", ints[:, slo, slv], XR[2])
    # CV1 block does not couple to GS (case 20)
    return tdm


def tdm_sgs(S, XL, XR, ints, n):
    return tdm_gss(S, XR, XL, ints, n)


def tdm_s(S, XL, XR, ints, n):
    """<Psi(S)|O|Psi'(S)>, cases 21-30 (`driver/tdm.py:61-127`)."""
    nc, no, nv = n
    slc, slo, slv = _slices(n)
    tdm = np.einsum("ia,xba,ib->x", XL[0], ints[:, slv, slv], XR[0])
    tdm -= np.einsum("ia,xji,ja->x", XL[0], ints[:, slc, slc], XR[0])
    if S == 0:
        return tdm
    # CO0-CO0 / OV0-OV0 / CV1-CV1 diagonals
    tdm += np.einsum("iu,xvu,iv->x", XL[1], ints[:, slo, slo], XR[1])
    tdm -= np.einsum("iu,xji,ju->x", XL[1], ints[:, slc, slc], XR[1])
    tdm += np.einsum("ua,xab,ub->x", XL[2], ints[:, slv, slv], XR[2])
    tdm -= np.einsum("ua,xuv,va->x", XL[2], ints[:, slo, slo], XR[2])
    tdm += np.einsum("ia,xab,ib->x", XL[3], ints[:, slv, slv], XR[3])
    tdm -= np.einsum("ia,xji,ja->x", XL[3], ints[:, slc, slc], XR[3])
    # CV0-CO0 (case 22) and transpose
    f = 1.0 / _SQ2
    tdm += f * np.einsum("ia,xat,it->x", XL[0], ints[:, slv, slo], XR[1])
    tdm += f * np.einsum("jt,xat,ja->x", XL[1], ints[:, slv, slo], XR[0])
    # CV0-OV0 (case 23) and transpose
    f = -1.0 / _SQ2
    tdm += f * np.einsum("ia,xti,ta->x", XL[0], ints[:, slo, slc], XR[2])
    tdm += f * np.einsum("tb,xti,ib->x", XL[2], ints[:, slo, slc], XR[0])
    # CO0-CV1 / OV0-CV1 (case 24 family) and transposes
    f = np.sqrt((1 + S) / (2 * S))
    tdm += f * np.einsum("iu,xub,ib->x", XL[1], ints[:, slo, slv], XR[3])
    tdm += f * np.einsum("jb,xub,ju->x", XL[3], ints[:, slo, slv], XR[1])
    tdm += f * np.einsum("ua,xju,ja->x", XL[2], ints[:, slc, slo], XR[3])
    tdm += f * np.einsum("jb,xju,ub->x", XL[3], ints[:, slc, slo], XR[2])
    return tdm


def tdm_s1(S, XL, XR, ints, n):
    """<Psi(S+1)|O|Psi'(S+1)>, case 31 (`driver/tdm.py:129-154`)."""
    slc, slo, slv = _slices(n)
    tdm = np.einsum("ia,xab,ib->x", XL[0], ints[:, slv, slv], XR[0])
    tdm -= np.einsum("ia,xji,ja->x", XL[0], ints[:, slc, slc], XR[0])
    return tdm


def tdm_s_1(S, XL, XR, ints, n):
    """<Psi(S-1)|O|Psi'(S-1)>, cases 1-15 (`driver/tdm.py:156-237`)."""
    nc, no, nv = n
    slc, slo, slv = _slices(n)
    tdm = np.zeros(3)
    # diagonal blocks: CV1, CO1, OV1, O1O2
    tdm += np.einsum("ia,xab,ib->x", XL[0], ints[:, slv, slv], XR[0])
    tdm -= np.einsum("ia,xji,ja->x", XL[0], ints[:, slc, slc], XR[0])
    tdm += np.einsum("iu,xut,it->x", XL[1], ints[:, slo, slo], XR[1])
    tdm -= np.einsum("iu,xji,ju->x", XL[1], ints[:, slc, slc], XR[1])
    tdm += np.einsum("ua,xab,ub->x", XL[2], ints[:, slv, slv], XR[2])
    tdm -= np.einsum("ua,xtu,ta->x", XL[2], ints[:, slo, slo], XR[2])
    tdm += np.einsum("vu,xut,vt->x", XL[3], ints[:, slo, slo], XR[3])
    tdm -= np.einsum("vu,xwv,wu->x", XL[3], ints[:, slo, slo], XR[3])
    # CV1-CO1, CV1-OV1 and transposes
    f = np.sqrt((2 * S + 1) / (2 * S))
    tdm += f * np.einsum("ia,xat,it->x", XL[0], ints[:, slv, slo], XR[1])
    tdm += f * np.einsum("jt,xat,ja->x", XL[1], ints[:, slv, slo], XR[0])
    tdm -= f * np.einsum("ia,xti,ta->x", XL[0], ints[:, slo, slc], XR[2])
    tdm -= f * np.einsum("tb,xti,ib->x", XL[2], ints[:, slo, slc], XR[0])
    # CO1-O1O2 and transpose
    f = -np.sqrt((2 * S) / (2 * S - 1))
    tdm += f * np.einsum("iu,xwi,wu->x", XL[1], ints[:, slo, slc], XR[3])
    tdm += f * np.einsum("wt,xwi,it->x", XL[3], ints[:, slo, slc], XR[1])
    # CO1-O1O1 and transpose
    f = -2.0 * S / np.sqrt(2 * S * (2 * S - 1))
    tdm += f * np.einsum("iu,xui,u->x", XL[1], ints[:, slo, slc], XR[4])
    tdm += f * np.einsum("u,xui,iu->x", XL[4], ints[:, slo, slc], XR[1])
    # OV1-O1O2 and transpose
    f = np.sqrt((2 * S) / (2 * S - 1))
    tdm += f * np.einsum("ua,xat,ut->x", XL[2], ints[:, slv, slo], XR[3])
    tdm += f * np.einsum("wt,xat,wa->x", XL[3], ints[:, slv, slo], XR[2])
    # OV1-O1O1 and transpose
    f = 2.0 * S / np.sqrt(2 * S * (2 * S - 1))
    tdm += f * np.einsum("ua,xau,u->x", XL[2], ints[:, slv, slo], XR[4])
    tdm += f * np.einsum("u,xau,ua->x", XL[4], ints[:, slv, slo], XR[2])
    # O1O2-O1O1 and transpose
    tdm += np.einsum("vu,xut,vt,t->x", XL[3], ints[:, slo, slo], np.eye(no), XR[4])
    tdm -= np.einsum("vu,xtv,ut,t->x", XL[3], ints[:, slo, slo], np.eye(no), XR[4])
    tdm += np.einsum("t,xut,vt,vu->x", XL[4], ints[:, slo, slo], np.eye(no), XR[3])
    tdm -= np.einsum("t,xtv,ut,vu->x", XL[4], ints[:, slo, slo], np.eye(no), XR[3])
    return tdm

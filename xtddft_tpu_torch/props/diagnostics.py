"""Excited-state diagnostics.

``spin_polarization`` is the reference's ``XSF_TDA.get_sp``
(`xtddft/XSF_TDA.py:215-258`, after JCTC 19, 7606 (2023)), counterpart of
the JAX package's `props/diagnostics.py`: for a triplet reference it
reports <LH|HL> (the SF-kernel matrix element of the HOMO->HOMO open-shell
density) and the exchange blocks <iH|Ha>, <iL|La> over closed x virtual
pairs, whose magnitudes diagnose how strongly spin polarization couples the
flip-down states.  The SF response and the exchange run on the Env's
device; the result is host data (with an optional printed top-10 table
like the reference's).
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.response.sigma import make_sf_vresp


def _top_abs(mat: np.ndarray, n: int = 10):
    flat = np.abs(mat).ravel()
    order = np.argsort(-flat)[: min(n, flat.size)]
    ii, aa = np.unravel_index(order, mat.shape)
    return [(float(mat[i, a]), int(i), int(a)) for i, a in zip(ii, aa)]


def spin_polarization(ref: Reference, method: int = 0, report: bool = False):
    """dict with 'lhhl', 'homo' (nc, nv), 'lumo' (nc, nv) for a triplet
    restricted-open reference (no == 2)."""
    if ref.no != 2:
        raise ValueError("spin_polarization diagnostic assumes a triplet "
                         "reference (no == 2)")
    env = ref.env
    nc, no = ref.nc, ref.no
    C = np.asarray(ref.mo_a)
    vresp = make_sf_vresp(ref, method)

    def host(t):
        return t.detach().cpu().double().numpy()

    h = C[:, nc: nc + 1]
    h_mo = C.T @ host(vresp(env.tensor((h @ h.T)[None])))[0] @ C
    lhhl = float(h_mo[nc + no, nc + no])

    def k_block(orb):
        k_mo = C.T @ host(env.get_k(env.tensor(orb @ orb.T))) @ C
        return np.array(k_mo[:nc, nc + no:])

    homo = k_block(C[:, nc: nc + 1])
    lumo = k_block(C[:, nc + 1: nc + 2])

    out = {"lhhl": lhhl, "homo": homo, "lumo": lumo}
    if report:
        print("=" * 49)
        print(f"<LH|HL> is {lhhl:9.6f}")
        for label, mat in (
            ("<iH|Ha>", homo),
            ("<iL|La>", lumo),
            ("<iH|Ha>-<iL|La>", homo - lumo),
            ("<iH|Ha>*<iL|La>", homo * lumo),
        ):
            print(f"Top 10 value in {label}:")
            for rank, (val, i, a) in enumerate(_top_abs(mat), 1):
                print(f"{rank:2d}  {val:9.6f}, CV is ({i + 1}, "
                      f"{a + nc + no + 1})")
        print("=" * 49)
    return out

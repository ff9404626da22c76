"""<dS^2> diagnostics for excited states (host numpy)."""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.response.reference_state import Reference


def xtda_delta_s2(ref: Reference, v: np.ndarray) -> np.ndarray:
    """X-TDA shortcut formula: exact because the ROKS alpha/beta orbitals
    coincide.  v is blocked CV(a)|OV(a)|CO(b)|CV(b), (dim, nstates)."""
    nc, no, nv = ref.nc, ref.no, ref.nv
    d1 = nc * nv
    d3 = (nc + no) * nv + nc * no
    cva = v[:d1, :].T
    cvb = v[d3:, :].T
    return (
        np.einsum("ij,ij->i", cva, cva)
        + np.einsum("ij,ij->i", cvb, cvb)
        - 2.0 * np.einsum("ij,ij->i", cva, cvb)
    )

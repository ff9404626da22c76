"""AO values (and gradients) on grid points.

Host-side numpy; computed once per (molecule, grid) and shipped to device
as dense (ngrid, nao) arrays for the XC quadrature einsums.
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.ints.shell import BasisLayout, cart2sph, cart_components


def eval_ao(layout: BasisLayout, coords: np.ndarray, deriv: int = 0) -> np.ndarray:
    """AO values on grid.

    deriv=0 -> (ngrid, nao); deriv=1 -> (4, ngrid, nao) with [val, ddx, ddy, ddz].
    """
    ng = coords.shape[0]
    nao = layout.nao
    ncomp = 1 if deriv == 0 else 4
    out = np.zeros((ncomp, ng, nao))
    for sh in layout.shells:
        r = coords - sh.center[None, :]  # (ng, 3)
        r2 = np.einsum("gd,gd->g", r, r)
        expv = np.exp(-sh.exps[None, :] * r2[:, None]) * sh.coefs[None, :]  # (ng, nprim)
        rad = expv.sum(axis=1)  # (ng,)
        comps = cart_components(sh.l)
        # cartesian monomials
        mono = np.empty((ng, len(comps)))
        for ci, (i, j, k) in enumerate(comps):
            mono[:, ci] = r[:, 0] ** i * r[:, 1] ** j * r[:, 2] ** k
        cart_val = mono * rad[:, None]
        C = cart2sph(sh.l)
        sl = slice(sh.ao_offset, sh.ao_offset + sh.nao)
        out[0, :, sl] = cart_val @ C
        if deriv >= 1:
            drad = -2.0 * (expv * sh.exps[None, :]).sum(axis=1)  # d(rad)/d(r2) * 2? see below
            # d/dx [mono * rad] = dmono/dx * rad + mono * (-2 a x) sum -> use drad
            for d in range(3):
                dmono = np.zeros((ng, len(comps)))
                for ci, (i, j, k) in enumerate(comps):
                    e = (i, j, k)
                    if e[d] > 0:
                        em = list(e)
                        em[d] -= 1
                        dmono[:, ci] = (
                            e[d]
                            * r[:, 0] ** em[0]
                            * r[:, 1] ** em[1]
                            * r[:, 2] ** em[2]
                        )
                cart_d = dmono * rad[:, None] + mono * (drad * r[:, d])[:, None]
                out[1 + d, :, sl] = cart_d @ C
    if deriv == 0:
        return out[0]
    return out

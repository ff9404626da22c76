"""Matrix-free in-core XSF-TDA sigma operator (the ``backend="incore"`` flip leg).

Counterpart of the JAX package's `response/sigma_xsf.py`: the SF-TDA-down
base response (exchange and the SF kernel, no Coulomb; `response/sigma.py
flip_apply`) plus the spin-adapted dA applied blockwise
(`response/xsf_terms.py`, its MO tensors from the in-core ERIs), with the
Sf=Si contaminant handled by compressing the OO block through the
orthogonal `vects` basis.
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.response.sigma import SigmaOperator, flip_apply
from xtddft_tpu_torch.response.spaces import sf_oo_projector
from xtddft_tpu_torch.response.xsf_terms import (
    apply_delta_a,
    delta_a_fock_blocks,
    delta_a_tensors_from_eri,
)


def xsf_sigma_operator(ref: Reference, SA: int | None = None, foo: float = 1.0,
                       fglobal: float = 1.0, method: int = 0,
                       remove: bool | None = None) -> SigmaOperator:
    """In-core XSF-TDA sigma in the blocked CV|CO|OV|OO layout (JAX
    `response/sigma_xsf.py:30`); with ``remove`` the OO block is the
    (no^2 - 1) columns of the projector."""
    env = ref.env
    dev, dt = env.device, env.dtype
    nc, no, nv = ref.nc, ref.no, ref.nv
    if SA is None:
        SA = 3 if ref.restricted_open else 0
    if remove is None:
        remove = ref.restricted_open and no > 0
    n_o, n_v = nc + no, no + nv
    d1, d2, d3 = nc * nv, nc * nv + nc * no, nc * nv + nc * no + no * nv
    noo = no * no - 1 if remove else no * no
    dim = d3 + noo
    apply = flip_apply(ref, "down", method)
    vects = env.tensor(sf_oo_projector(no)) if remove else None
    dA_on = SA > 0 and ref.restricted_open and no > 0
    if dA_on:
        si = 0.5 * no
        T = delta_a_tensors_from_eri(ref, SA)
        T.update(delta_a_fock_blocks(ref.fock_a_hf_mo, ref.fock_b_hf_mo, nc, no, dt, dev))

    def matvec(zs):
        zs = torch.as_tensor(zs, dtype=dt, device=dev)
        nz = zs.shape[0]
        zcv = zs[:, :d1].reshape(nz, nc, nv)
        zco = zs[:, d1:d2].reshape(nz, nc, no)
        zov = zs[:, d2:d3].reshape(nz, no, nv)
        zoo = (zs[:, d3:] @ vects.T if remove else zs[:, d3:]).reshape(nz, no, no)
        # the natural (n_o, n_v) layout: rows C|O, columns O|V
        z = torch.zeros((nz, n_o, n_v), dtype=dt, device=dev)
        z[:, :nc, no:] = zcv
        z[:, :nc, :no] = zco
        z[:, nc:, no:] = zov
        z[:, nc:, :no] = zoo
        vs = apply(z)
        if dA_on:
            dcv, dco, dov, doo = apply_delta_a(T, si, SA, foo, zcv, zco, zov, zoo)
            vs[:, :nc, no:] += fglobal * dcv
            vs[:, :nc, :no] += fglobal * dco
            vs[:, nc:, no:] += fglobal * dov
            vs[:, nc:, :no] += fglobal * doo
        ooo = vs[:, nc:, :no].reshape(nz, -1)
        if remove:
            ooo = ooo @ vects
        return torch.cat([vs[:, :nc, no:].reshape(nz, -1), vs[:, :nc, :no].reshape(nz, -1),
                          vs[:, nc:, no:].reshape(nz, -1), ooo], dim=1)

    # the diagonal from orbital-energy differences, in blocked order
    e_occ = np.diag(ref.fock_a_mo)[:n_o]
    e_vir = np.diag(ref.fock_b_mo)[nc:]
    e_full = e_vir[None, :] - e_occ[:, None]
    h_oo = e_full[nc:, :no].ravel()
    if remove:
        V = sf_oo_projector(no)
        h_oo = np.einsum("pq,p,pq->q", V, h_oo, V)
    hdiag = np.concatenate([e_full[:nc, no:].ravel(), e_full[:nc, :no].ravel(),
                            e_full[nc:, no:].ravel(), h_oo])

    def expand(v):
        """The compressed OO block back to the full no^2 block."""
        if not remove:
            return v
        return np.concatenate([v[:d3], sf_oo_projector(no) @ v[d3:]], axis=0)

    return SigmaOperator(matvec=matvec, hdiag=hdiag, dim=dim, _to_blocked=expand,
                         device=dev, dtype=dt)

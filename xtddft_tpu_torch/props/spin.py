"""<dS^2> diagnostics for excited states (host numpy)."""

from __future__ import annotations

import numpy as np
import torch

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


def utda_delta_s2(ref: Reference, v: np.ndarray) -> np.ndarray:
    """General UKS formula with the alpha-beta overlap matrices, blocked
    CV(a)|OV(a)|CO(b)|CV(b) eigenvectors (JAX `props/spin.py:25`)."""
    nc, no, nv = ref.nc, ref.no, ref.nv
    S = ref.env.S.detach().to("cpu", torch.float64).numpy()
    oa, va = ref.orbo_a, ref.orbv_a
    ob, vb = ref.orbo_b, ref.orbv_b
    Sccba = ob.T @ S @ oa  # (nc, nc+no)
    Sccab = oa.T @ S @ ob  # (nc+no, nc)
    Svcab = va.T @ S @ ob  # (nv, nc)
    Svcba = vb.T @ S @ oa  # (no+nv, nc+no)
    Svvab = va.T @ S @ vb  # (nv, no+nv)
    ns = v.shape[1]
    d1 = nc * nv
    d2 = (nc + no) * nv
    d3 = d2 + nc * no
    cva = v[:d1].T.reshape(ns, nc, nv)
    ova = v[d1:d2].T.reshape(ns, no, nv)
    cob = v[d2:d3].T.reshape(ns, nc, no)
    cvb = v[d3:].T.reshape(ns, nc, nv)
    e = np.einsum
    return (
        e("nia,nja,ki,jk->n", cva, cva, Sccba[:, :nc], Sccba.T[:nc, :])
        + e("nia,nja,ki,jk->n", ova, ova, Sccba[:, nc:], Sccba.T[nc:, :])
        + e("nia,nja,ki,jk->n", ova, cva, Sccba[:, nc:], Sccba.T[:nc, :])
        + e("nia,nja,ki,jk->n", cva, ova, Sccba[:, :nc], Sccba.T[nc:, :])
        - e("nia,nib,ak,kb->n", cva, cva, Svcab, Svcab.T)
        - e("nia,nib,ak,kb->n", ova, ova, Svcab, Svcab.T)
        + e("nia,nja,ki,jk->n", cvb, cvb, Sccab, Sccab.T)
        + e("nia,nja,ki,jk->n", cob, cob, Sccab, Sccab.T)
        - e("nia,nib,ak,kb->n", cob, cob, Svcba[:no, :], Svcba.T[:, :no])
        - e("nia,nib,ak,kb->n", cvb, cvb, Svcba[no:, :], Svcba.T[:, no:])
        - e("nia,nib,ak,kb->n", cob, cvb, Svcba[:no, :], Svcba.T[:, no:])
        - e("nia,nib,ak,kb->n", cvb, cob, Svcba[no:, :], Svcba.T[:, :no])
        - 2 * e("nia,njb,ji,ab->n", cva, cvb, Sccba[:, :nc], Svvab[:, no:])
        - 2 * e("nia,njb,ji,ab->n", cva, cob, Sccba[:, :nc], Svvab[:, :no])
        - 2 * e("nia,njb,ji,ab->n", ova, cvb, Sccba[:, nc:], Svvab[:, no:])
        - 2 * e("nia,njb,ji,ab->n", ova, cob, Sccba[:, nc:], Svvab[:, :no])
    )


def xsf_delta_s2_roks(ref: Reference, v_full: np.ndarray) -> np.ndarray:
    """ROKS SF-down <dS^2> diagnostic: ds2 = -2*S_gs + 1 + sum(cv^2) - sum(oo^2)
    + (tr oo)^2, with v in the full CV|CO|OV|OO layout."""
    nc, no, nv = ref.nc, ref.no, ref.nv
    d1 = nc * nv
    d3 = d1 + nc * no + no * nv
    out = []
    sgs = ref.si
    for k in range(v_full.shape[1]):
        x_cv = v_full[:d1, k]
        x_oo = v_full[d3:, k].reshape(no, no)
        dp = float(x_cv @ x_cv) - float(np.sum(x_oo * x_oo)) + float(np.trace(x_oo)) ** 2
        out.append(-2.0 * sgs + 1.0 + dp)
    return np.array(out)


def xsf_delta_s2_uks(ref: Reference, v_full: np.ndarray) -> np.ndarray:
    """UKS SF-down <dS^2> via overlaps."""
    nc, no, nv = ref.nc, ref.no, ref.nv
    S = ref.env.S.cpu().numpy().astype(np.float64)
    mooa = ref.orbo_a
    moob = ref.orbo_b
    mova = ref.orbv_a
    movb = ref.orbv_b
    sba_oo = (mooa.T @ S @ moob).T
    sab_vo = mova.T @ S @ moob
    sba_vo = movb.T @ S @ mooa
    d1 = nc * nv
    d2 = d1 + nc * no
    d3 = d2 + no * nv
    out = []
    for k in range(v_full.shape[1]):
        val = v_full[:, k]
        x_cv = val[:d1].reshape(nc, nv)
        x_co = val[d1:d2].reshape(nc, no)
        x_ov = val[d2:d3].reshape(no, nv)
        x_oo = val[d3:].reshape(no, no)
        t1 = np.hstack([x_co, x_cv])
        t2 = np.hstack([x_oo, x_ov])
        x_ba = np.concatenate([t1, t2], axis=0).T  # (no+nv, nc+no)
        P = (
            np.einsum("ai,aj,jk,ki", x_ba, x_ba, sba_oo.T, sba_oo)
            - np.einsum("ai,bi,kb,ak", x_ba, x_ba, sba_vo.T, sba_vo)
            + np.einsum("ai,bj,jb,ai", x_ba, x_ba, sba_vo.T, sba_vo)
        )
        out.append(P - no + 1.0)
    return np.array(out)

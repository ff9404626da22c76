"""End-to-end SOC-SI composition: XSF-TDA (|S->) + tensor-basis X-TDA
(|S0>) + SF-TDA-up (|S+>) + SOMF Vso -> state interaction.

Counterpart of the JAX package's `soc/pipeline.py`, the reference pipeline
`x2c_hamiltonian/test_SOCSI.py:35-128` (soc_mf): the three manifolds'
eigenvectors in the SI layouts from the port's drivers, Vso in the MO
basis, and Heff diagonalized.  The driver it returns also carries
``legs``: the seconds and kernel launches of each stage.
"""

from __future__ import annotations

import time

import numpy as np

from xtddft_tpu_torch import kernels
from xtddft_tpu_torch.methods.drivers import SFTDA, XSFTDA, XTDA, _ref_of
from xtddft_tpu_torch.response.spaces import so2st
from xtddft_tpu_torch.soc.si import SIDriver
from xtddft_tpu_torch.soc.somf import build_vso


def sm_states_from_xsf(res, nc: int, no: int, nv: int):
    """|S-> states: XSF-TDA eigenvectors (CV|CO|OV|OO with OO re-expanded)
    split into [CV|CO|OV|O1O2|O1O1] (`test_SOCSI.py:45-70`)."""
    d3 = nc * nv + nc * no + no * nv
    out = []
    for k in range(res.e.shape[0]):
        x = res.v[:, k]
        oo = x[d3:].reshape(no, no)
        diag = np.diag(oo).copy()
        offd = oo - np.diag(diag)
        xi = np.concatenate([x[:d3], offd.reshape(-1), diag])
        out.append((float(res.e[k]), xi))
    return out


def s0_states_from_xtda(res, nc: int, no: int, nv: int):
    """|S0> states: blocked CVa|OVa|COb|CVb -> spin tensor [CV0|CO0|OV0|CV1]
    (so2st + OV/CO swap, `utils/utils.py:67-94,125-131`)."""
    vst = so2st(res.v, nc, no, nv)  # [CV0 | OV0 | CO0 | CV1]
    d1 = nc * nv
    d2 = d1 + no * nv
    d3 = d2 + nc * no
    out = []
    for k in range(res.e.shape[0]):
        x = vst[:, k]
        xi = np.concatenate([x[:d1], x[d2:d3], x[d1:d2], x[d3:]])
        out.append((float(res.e[k]), xi))
    return out


def sp_states_from_sfup(res):
    """|S+> states: SF-TDA-up CV(beta->alpha) vectors, used as-is."""
    return [(float(res.e[k]), res.v[:, k].copy()) for k in range(res.e.shape[0])]


def run_soc_si(mf, nstates: int = 10, ngs: bool = True, iop: str = "x2c",
               include_mf2e: bool = True, use_1c: bool = True,
               cal_osc: bool = False, sf_method: int = 2) -> SIDriver:
    """Full SOC-SI pipeline on a converged open-shell MeanField (S >= 1).

    sf_method: XC treatment for the spin-flip manifolds (2 = collinear
    exchange-only, the robust default; 0 = ALDA0)."""
    legs = {}

    def leg(name, fn):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        after = kernels.launch_counts()
        legs[name] = {"s": time.perf_counter() - t0,
                      "launches": {k: after[k] - before[k] for k in after}}
        return out

    ref = leg("reference", lambda: _ref_of(mf))
    nc, no, nv = ref.nc, ref.no, ref.nv
    S = 0.5 * no
    states = {}
    if S >= 1:
        xsf = leg("xsf", lambda: XSFTDA(ref, nstates=nstates, method=sf_method).kernel(
            remove=True))
        states["S-"] = sm_states_from_xsf(xsf, nc, no, nv)
    xtda = leg("xtda", lambda: XTDA(ref, nstates=nstates).kernel())
    states["S0"] = s0_states_from_xtda(xtda, nc, no, nv)
    sfu = leg("sfup", lambda: SFTDA(ref, nstates=nstates, extype="up",
                                    method=sf_method).kernel())
    states["S+"] = sp_states_from_sfup(sfu)

    vso = leg("vso", lambda: build_vso(mf, iop=iop, include_mf2e=include_mf2e,
                                       use_1c=use_1c))
    mo = ref.mo_a
    vso_mo = np.einsum("xpq,pi,qj->xij", vso.vso, mo, mo)

    dip_mo = None
    mu_nuc = None
    if cal_osc:
        cc = ref.env.mol.charge_center()
        dip_ao = ref.env.dip_about(cc).cpu().numpy()
        dip_mo = np.einsum("xpq,pi,qj->xij", dip_ao, mo, mo)
        dm = np.asarray(mf.make_rdm1())
        dm_tot = dm.sum(axis=0) if dm.ndim == 3 else dm
        mu_nuc = np.einsum("xpq,qp->x", dip_ao, dm_tot)

    si = SIDriver(S=S, nc=nc, no=no, nv=nv, vso_mo=vso_mo, states=states, ngs=ngs,
                  dip_mo=dip_mo, mu_nuc=mu_nuc)
    leg("si", si.kernel)
    si.legs = legs
    si.vso_seconds = vso.seconds
    return si

"""Matrix-free batched sigma operators (the Davidson hot path).

A `SigmaOperator` packages ``matvec(Z) -> AZ`` over stacked trial vectors
(torch tensors on the device) with its diagonal and blocked layout.
Counterpart of the JAX package's `response/sigma.py`, with its in-core
operators (the ``backend="incore"`` route of the drivers):

- spin-conserving UTDA/X-TDA (`spin_conserving_sigma`,
  `xtda_sigma_operator`, `utda_sigma_operator`);
- spin-flip SF-TDA up/down (`sf_sigma_operator`, on `make_sf_vresp`);

each a response in the AO basis per build: the transition matrices of the
trial vectors, J and K as products with the in-core ERI matrices
(`scf/env.py`), the XC terms on the kernels K2 and K3
(`xc/interface.fxc_v1mat`, `sf_v1mat`, `xc/mcol.sf_v1mat_mcol`), then the
MO back-transform and the Fock couplings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.xc import interface as xci


def _rho0(ref: Reference):
    """Ground-state grid densities (ra, rb, ga, gb) on the Env's device, and
    (ta, tb) after them for a meta-GGA (JAX `response/sigma.py:28`): one K2
    launch in its hermitian mode."""
    env = ref.env
    tau = ref.spec is not None and ref.spec.needs_tau
    r, g, *t = xci.cache_rho(env.ao, env.tensor(np.stack([ref.orbo_a @ ref.orbo_a.T,
                                                          ref.orbo_b @ ref.orbo_b.T])),
                             tau=tau)
    return (r[0], r[1], g[0], g[1]) + ((t[0][0], t[0][1]) if tau else ())


@dataclasses.dataclass
class SigmaOperator:
    matvec: Callable  # (n, dim) tensor -> (n, dim) tensor
    hdiag: np.ndarray
    dim: int
    _to_blocked: Callable | None = None
    device: torch.device | None = None  # where matvec computes
    dtype: torch.dtype | None = None
    setup_s: dict = dataclasses.field(default_factory=dict)  # one-off steps of the build

    def init_guess(self, nstates: int, spread: float = 1e-3) -> np.ndarray:
        """Koopmans guess: unit vectors on the lowest diagonal gaps; every
        gap within ``spread`` of the n-th one is included, so degenerate
        gaps can give more rows than ``nstates``."""
        n = min(nstates, self.dim)
        thresh = np.partition(self.hdiag, n - 1)[n - 1] + spread
        idx = np.where(self.hdiag <= thresh)[0]
        x0 = np.zeros((idx.size, self.dim))
        x0[np.arange(idx.size), idx] = 1.0
        return x0

    def to_blocked(self, v: np.ndarray) -> np.ndarray:
        return v if self._to_blocked is None else self._to_blocked(v)


def _rsh_k(ref: Reference) -> bool:
    return ref.omega != 0 and abs(ref.alpha - ref.hyb) > 1e-12


def _uks_vresp(ref: Reference):
    """vresp(dms (n, 2, nao, nao)) -> v1ao (n, 2, nao, nao): J + fxc - hyb K
    (+ the RSH long-range K), for transition matrices of any symmetry (JAX
    `response/sigma.py:80` `_uks_vresp_consts` / `_uks_vresp_raw`)."""
    env = ref.env
    spec, hyb, alpha = ref.spec, ref.hyb, ref.alpha
    rsh = _rsh_k(ref)
    has_xc = spec is not None and bool(spec.components)
    rho0 = _rho0(ref) if has_xc else None

    def vresp(dms):
        n, nao = dms.shape[0], dms.shape[-1]
        vj = env.incore_j(dms[:, 0] + dms[:, 1])
        v1 = torch.stack([vj, vj], dim=1)
        if has_xc:
            v1 = v1 + xci.fxc_v1mat(spec, env.ao, env.grid_weights, rho0, dms, hermi=False)
        if hyb != 0.0 or rsh:
            flat = dms.reshape(-1, nao, nao)
            vk = hyb * env.incore_k(flat)
            if rsh:
                vk = vk + (alpha - hyb) * env.incore_k(flat, ref.omega)
            v1 = v1 - vk.reshape(n, 2, nao, nao)
        return v1

    return vresp


def spin_conserving_sigma(ref: Reference, spin_adapt: bool | None = None) -> SigmaOperator:
    """Batched in-core sigma for UTDA (spin_adapt=False) / X-TDA (ROKS, dA
    on), JAX `response/sigma.py:126`.

    Vector layout: [ z_alpha (nocc_a*nvir_a) | z_beta (nocc_b*nvir_b) ]
    with z_beta row-major over (C, [O,V]), the 'interleaved' layout;
    `to_blocked` gives the CV|OV|CO|CV property layout.
    """
    if spin_adapt is None:
        spin_adapt = ref.restricted_open
    env = ref.env
    dev, dt = env.device, env.dtype
    nc, no, nv = ref.nc, ref.no, ref.nv
    nocca, nvira = ref.nocc_a, ref.nvir_a
    noccb, nvirb = ref.nocc_b, ref.nvir_b
    na = nocca * nvira
    dim = na + noccb * nvirb
    vresp = _uks_vresp(ref)
    oa, vaa = env.tensor(ref.orbo_a), env.tensor(ref.orbv_a)
    ob, vbb = env.tensor(ref.orbo_b), env.tensor(ref.orbv_b)
    fa, fb = env.tensor(ref.fock_a_mo), env.tensor(ref.fock_b_mo)
    fa_vv, fa_oo = fa[nocca:, nocca:], fa[:nocca, :nocca]
    fb_vv, fb_oo = fb[noccb:, noccb:], fb[:noccb, :noccb]
    dA = spin_adapt and ref.restricted_open and no > 0
    if dA:
        si = 0.5 * no
        dF = ref.fock_b_hf_mo - ref.fock_a_hf_mo
        dFV = env.tensor(dF[nc + no:, nc + no:])
        dFC = env.tensor(dF[:nc, :nc])
        f1 = float(0.5 * (1.0 - np.sqrt((si + 1) / si) + 1.0 / (2 * si)))
        f2 = float(0.5 * (-1.0 + np.sqrt((si + 1) / si) + 1.0 / (2 * si)))
        fx = float(0.5 / (2.0 * si))

    def matvec(zs):
        zs = torch.as_tensor(zs, dtype=dt, device=dev)
        nz = zs.shape[0]
        za = zs[:, :na].reshape(nz, nocca, nvira)
        zb = zs[:, na:].reshape(nz, noccb, nvirb)
        # dm[x, p, q] = sum_ov v[p, v] z[x, o, v] o[q, o]
        dma = vaa @ za.transpose(1, 2) @ oa.T
        dmb = vbb @ zb.transpose(1, 2) @ ob.T
        v1ao = vresp(torch.stack([dma, dmb], dim=1))
        v1a = oa.T @ v1ao[:, 0].transpose(1, 2) @ vaa
        v1b = ob.T @ v1ao[:, 1].transpose(1, 2) @ vbb
        # Fock couplings (ROKS orbitals are not canonical per spin)
        v1a = v1a + za @ fa_vv.T - fa_oo @ za
        v1b = v1b + zb @ fb_vv.T - fb_oo @ zb
        if dA:
            zac = za[:, :noccb, :]
            zbv = zb[:, :, -nvira:]
            coup_a = f1 * (zac @ dFV.T) + f2 * (dFC @ zac)
            cross_b = fx * (zbv @ dFV.T + dFC @ zbv)
            coup_b = f2 * (zbv @ dFV.T) + f1 * (dFC @ zbv)
            cross_a = fx * (zac @ dFV.T + dFC @ zac)
            v1a[:, :noccb, :] += coup_a - cross_b
            v1b[:, :, -nvira:] += coup_b - cross_a
        return torch.cat([v1a.reshape(nz, -1), v1b.reshape(nz, -1)], dim=1)

    ea, eb = np.diag(ref.fock_a_mo), np.diag(ref.fock_b_mo)
    hdiag = np.concatenate([(ea[nocca:][None, :] - ea[:nocca][:, None]).ravel(),
                            (eb[noccb:][None, :] - eb[:noccb][:, None]).ravel()])

    def to_blocked(v):
        # beta interleaved (C rows x [O,V] cols) -> CO | CV blocks
        top = v[:na]
        beta = v[na:].reshape(noccb, nvirb, -1)
        co = beta[:, :no].reshape(noccb * no, -1)
        cv = beta[:, no:].reshape(noccb * nv, -1)
        return np.concatenate([top, co, cv], axis=0)

    return SigmaOperator(matvec=matvec, hdiag=hdiag, dim=dim, _to_blocked=to_blocked,
                         device=dev, dtype=dt)


def xtda_sigma_operator(ref: Reference) -> SigmaOperator:
    return spin_conserving_sigma(ref, spin_adapt=True)


def utda_sigma_operator(ref: Reference) -> SigmaOperator:
    return spin_conserving_sigma(ref, spin_adapt=False)


def make_sf_vresp(ref: Reference, method: int = 0):
    """vresp(dms (n, nao, nao)) -> v1ao for alpha->beta transition matrices:
    the ALDA0 (method 0) or multicollinear (1) kernel, or none (2,
    collinear), minus hyb K (+ the RSH long-range K); no J (JAX
    `response/sigma.py:282` `make_sf_vresp`).  A meta-GGA's multicollinear
    kernel carries the tau row and column; its ALDA0 kernel raises, as the
    JAX package's does."""
    env = ref.env
    hyb, alpha = ref.hyb, ref.alpha
    rsh = _rsh_k(ref)
    fw = fH = None
    if method in (0, 1) and ref.spec is not None and bool(ref.spec.components):
        if method == 0:
            fw = xci.sf_kernel_alda0(ref.spec, env.grid_weights, _rho0(ref))
        else:
            from xtddft_tpu_torch.xc.mcol import sf_kernel_mcol

            fH = sf_kernel_mcol(ref.spec, env.grid_weights, _rho0(ref))

    def vresp(dms):
        v1 = torch.zeros_like(dms)
        if fw is not None:
            v1 = v1 + xci.sf_v1mat(env.ao, fw, dms)
        elif fH is not None:
            from xtddft_tpu_torch.xc.mcol import sf_v1mat_mcol

            v1 = v1 + sf_v1mat_mcol(env.ao, fH, dms)
        if hyb != 0.0 or rsh:
            vk = hyb * env.incore_k(dms)
            if rsh:
                vk = vk + (alpha - hyb) * env.incore_k(dms, ref.omega)
            v1 = v1 - vk
        return v1

    return vresp


def flip_apply(ref: Reference, extype: str, method: int = 0):
    """The in-core spin-flip response on the natural (n_o, n_v) block (down:
    rows C|O alpha occupied, columns O|V beta virtual; up: beta occupied,
    alpha virtual): apply(z (nz, n_o, n_v)) -> (nz, n_o, n_v), Fock
    couplings included.  Shared by `sf_sigma_operator` and
    `sigma_xsf.xsf_sigma_operator`."""
    env = ref.env
    if extype == "down":
        orbo, orbv = env.tensor(ref.orbo_a), env.tensor(ref.orbv_b)
        f_occ = env.tensor(ref.fock_a_mo[:ref.nocc_a, :ref.nocc_a])
        f_vir = env.tensor(ref.fock_b_mo[ref.nocc_b:, ref.nocc_b:])
    else:
        orbo, orbv = env.tensor(ref.orbo_b), env.tensor(ref.orbv_a)
        f_occ = env.tensor(ref.fock_b_mo[:ref.nocc_b, :ref.nocc_b])
        f_vir = env.tensor(ref.fock_a_mo[ref.nocc_a:, ref.nocc_a:])
    vresp = make_sf_vresp(ref, method)

    def apply(z):
        dms = orbo @ z @ orbv.T
        vs = orbo.T @ vresp(dms) @ orbv
        return vs + z @ f_vir.T - f_occ @ z

    return apply


def sf_sigma_operator(ref: Reference, extype: str = "down", method: int = 0) -> SigmaOperator:
    """Plain in-core SF-TDA sigma over the full (occ, vir) space (JAX
    `response/sigma.py:289`).

    'down': z (nocc_a, nvir_b) row-major over (C+O, [O,V]);
    'up':   z (nocc_b, nvir_a).
    """
    env = ref.env
    nc, no, nv = ref.nc, ref.no, ref.nv
    if extype == "down":
        n_o, n_v = ref.nocc_a, ref.nvir_b
        e_occ = np.diag(ref.fock_a_mo)[:ref.nocc_a]
        e_vir = np.diag(ref.fock_b_mo)[ref.nocc_b:]
    elif extype == "up":
        n_o, n_v = ref.nocc_b, ref.nvir_a
        e_occ = np.diag(ref.fock_b_mo)[:ref.nocc_b]
        e_vir = np.diag(ref.fock_a_mo)[ref.nocc_a:]
    else:
        raise ValueError(f"extype must be 'up' or 'down', got {extype!r}")
    apply = flip_apply(ref, extype, method)

    def matvec(zs):
        zs = torch.as_tensor(zs, dtype=env.dtype, device=env.device)
        return apply(zs.reshape(-1, n_o, n_v)).reshape(zs.shape[0], -1)

    hdiag = (e_vir[None, :] - e_occ[:, None]).ravel()

    def to_blocked(v):
        # (C+O rows x [O,V] cols) row-major -> CV | CO | OV | OO
        z = v.reshape(n_o, n_v, -1)
        cv = z[:nc, no:].reshape(nc * nv, -1)
        co = z[:nc, :no].reshape(nc * no, -1)
        ov = z[nc:, no:].reshape(no * nv, -1)
        oo = z[nc:, :no].reshape(no * no, -1)
        return np.concatenate([cv, co, ov, oo], axis=0)

    return SigmaOperator(matvec=matvec, hdiag=hdiag, dim=n_o * n_v,
                         _to_blocked=to_blocked if extype == "down" else None,
                         device=env.device, dtype=env.dtype)

"""Dense response-matrix builders (the small-molecule backend).

Counterpart of the JAX package's `response/dense.py`; every matrix is
assembled on the Env's device in its dtype (f64), from the in-core ERIs
(`response/moeri.py`) and the dense fxc tensors (`response/fxc_tensor.py`,
`xc/mcol.py`), and the drivers diagonalize it there:

- ``utda_blocks``    UKS-TDA aa/ab/bb tensors
- ``tda_singlet_dense``/``tda_triplet_dense`` closed-shell TDA
- ``utda_dense``     unrestricted TDA (X-TDA without dA)
- ``xtda_dense``     spin-adapted X-TDA with dA
- ``sf_up_dense``    SF-TDA spin-flip-up
- ``sf_down_dense``  SF-TDA spin-flip-down
- ``xsf_delta_a``/``xsf_dense`` XSF-TDA dA on top of SF-down

All matrices use the blocked layouts of `response/spaces.py`.  The ground
state density on the grid comes from K2 (`xc/interface.cache_rho`).
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.response.fxc_tensor import DENSE_CHUNK, fxc_blocks
from xtddft_tpu_torch.response.moeri import mo_eri
from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.response.sigma import _rho0
from xtddft_tpu_torch.response.spaces import sf_oo_projector
from xtddft_tpu_torch.xc.interface import sf_kernel_alda0


def _t(ref: Reference, a) -> torch.Tensor:
    return ref.env.tensor(a)


def _eye(ref: Reference, n: int) -> torch.Tensor:
    return torch.eye(n, dtype=ref.env.dtype, device=ref.env.device)


def _ein(spec: str, *ops) -> torch.Tensor:
    return torch.einsum(spec, *ops)


def _k_eri(ref: Reference, co, cv) -> torch.Tensor:
    """(ij|ab) exchange-type MO integrals with RSH handling:
    hyb*(ij|ab) + (alpha-hyb)*(ij|ab)_omega."""
    env = ref.env
    out = ref.hyb * mo_eri(env.eri, co, co, cv, cv)
    if ref.omega != 0.0 and abs(ref.alpha - ref.hyb) > 1e-12:
        out = out + (ref.alpha - ref.hyb) * mo_eri(env.eri_omega(ref.omega), co, co, cv, cv)
    return out


def _same_orbitals(ref: Reference) -> bool:
    """The alpha and beta (occupied, virtual) splits are the same orbitals."""
    return ref.nocc_a == ref.nocc_b and (
        ref.mo_a is ref.mo_b or np.array_equal(ref.mo_a, ref.mo_b))


def utda_blocks(ref: Reference):
    """(aa, ab, bb) 4-index tensors of the UKS-TDA coupling matrix
    (no orbital-energy/Fock diagonal terms)."""
    oa, va = _t(ref, ref.orbo_a), _t(ref, ref.orbv_a)
    ob, vb = _t(ref, ref.orbo_b), _t(ref, ref.orbv_b)
    eri = ref.env.eri
    aa = mo_eri(eri, oa, va, oa, va)
    bb = mo_eri(eri, ob, vb, ob, vb)
    ab = mo_eri(eri, oa, va, ob, vb)
    aa = aa - _k_eri(ref, oa, va).permute(0, 2, 1, 3)
    bb = bb - _k_eri(ref, ob, vb).permute(0, 2, 1, 3)
    if ref.spec is not None and ref.spec.components:
        env = ref.env
        faa, fab, fbb = fxc_blocks(ref.spec, env.ao, env.grid_weights, _rho0(ref),
                                   (oa, va), (ob, vb), same=_same_orbitals(ref))
        aa = aa + faa.reshape(aa.shape)
        ab = ab + fab.reshape(ab.shape)
        bb = bb + fbb.reshape(bb.shape)
    return aa, ab, bb


def _tda_dense(ref: Reference, sign: float) -> torch.Tensor:
    aa, ab, _ = utda_blocks(ref)
    no_, nv_ = aa.shape[0], aa.shape[1]
    f = _t(ref, np.diag(ref.fock_a_mo))
    e_ia = (f[no_:][None, :] - f[:no_][:, None]).reshape(-1)
    return (aa + sign * ab).reshape(no_ * nv_, no_ * nv_) + torch.diag(e_ia)


def tda_singlet_dense(ref: Reference) -> torch.Tensor:
    """Closed-shell singlet TDA matrix (nocc*nvir square), orbital-energy
    diagonal included."""
    return _tda_dense(ref, 1.0)


def tda_triplet_dense(ref: Reference) -> torch.Tensor:
    return _tda_dense(ref, -1.0)


def utda_dense(ref: Reference) -> torch.Tensor:
    """Unrestricted TDA in the blocked CV(a)|OV(a)|CO(b)|CV(b) layout with
    Fock diagonal terms (UKS, and ROKS-as-UKS without dA)."""
    return xtda_dense(ref, spin_adapt=False)


def xtda_dense(ref: Reference, spin_adapt: bool = True) -> torch.Tensor:
    """Spin-adapted X-TDA dense matrix.

    Layout: CV(aa)[nc*nv] | OV(aa)[no*nv] | CO(bb)[nc*no] | CV(bb)[nc*nv],
    dim = (nc+no)*nv + nc*(no+nv).
    """
    nc, no, nv = ref.nc, ref.no, ref.nv
    fa = _t(ref, ref.fock_a_mo)
    fb = _t(ref, ref.fock_b_mo)
    aa, ab, bb = utda_blocks(ref)
    dim = (nc + no) * nv + nc * (no + nv)
    A = torch.zeros((dim, dim), dtype=ref.env.dtype, device=ref.env.device)
    d1 = nc * nv
    d2 = (nc + no) * nv
    d3 = d2 + nc * no
    I_c, I_o, I_v = _eye(ref, nc), _eye(ref, no), _eye(ref, nv)
    faVV = fa[nc + no:, nc + no:]
    faCC = fa[:nc, :nc]
    faCO = fa[:nc, nc:nc + no]
    faOO = fa[nc:nc + no, nc:nc + no]
    fbOO = fb[nc:nc + no, nc:nc + no]
    fbCC = fb[:nc, :nc]
    fbOV = fb[nc:nc + no, nc + no:]
    fbVV = fb[nc + no:, nc + no:]

    def sym(r, c, blk):
        A[r, c] = blk
        A[c, r] = blk.T

    s1, s2, s3, s4 = slice(0, d1), slice(d1, d2), slice(d2, d3), slice(d3, dim)
    A[s1, s1] = (_ein("ij,ab->iajb", I_c, faVV) - _ein("ij,ab->iajb", faCC, I_v)
                 + aa[:nc, :, :nc, :]).reshape(d1, d1)
    sym(s1, s2, (-_ein("ij,ab->iajb", faCO, I_v) + aa[:nc, :, nc:nc + no, :]).reshape(d1, no * nv))
    sym(s1, s3, ab[:nc, :, :, :no].reshape(d1, nc * no))
    cvaacvbb = ab[:nc, :, :, no:].reshape(d1, nc * nv)
    A[s2, s2] = (_ein("ij,ab->iajb", I_o, faVV) - _ein("ij,ab->iajb", faOO, I_v)
                 + aa[nc:nc + no, :, nc:nc + no, :]).reshape(no * nv, no * nv)
    sym(s2, s3, ab[nc:nc + no, :, :, :no].reshape(no * nv, nc * no))
    sym(s2, s4, ab[nc:nc + no, :, :, no:].reshape(no * nv, nc * nv))
    A[s3, s3] = (_ein("ij,ab->iajb", I_c, fbOO) - _ein("ij,ab->iajb", fbCC, I_o)
                 + bb[:, :no, :, :no]).reshape(nc * no, nc * no)
    sym(s3, s4, (_ein("ij,ab->iajb", I_c, fbOV) + bb[:, :no, :, no:]).reshape(nc * no, nc * nv))
    A[s4, s4] = (_ein("ij,ab->iajb", I_c, fbVV) - _ein("ij,ab->iajb", fbCC, I_v)
                 + bb[:, no:, :, no:]).reshape(nc * nv, nc * nv)

    if spin_adapt and ref.restricted_open and no > 0:
        si = 0.5 * no
        fahf = _t(ref, ref.fock_a_hf_mo)
        fbhf = _t(ref, ref.fock_b_hf_mo)
        dFV = fbhf[nc + no:, nc + no:] - fahf[nc + no:, nc + no:]
        dFC = fbhf[:nc, :nc] - fahf[:nc, :nc]
        f1 = 0.5 * (1.0 - np.sqrt((si + 1.0) / si) + 1.0 / (2.0 * si))
        f2 = 0.5 * (-1.0 + np.sqrt((si + 1.0) / si) + 1.0 / (2.0 * si))
        cV = _ein("ij,ab->iajb", I_c, dFV).reshape(d1, d1)
        cC = _ein("ij,ab->iajb", dFC, I_v).reshape(d1, d1)
        A[s1, s1] += f1 * cV + f2 * cC
        A[s4, s4] += f2 * cV + f1 * cC
        cvaacvbb = cvaacvbb - 0.5 / (2.0 * si) * (cV + cC)
    sym(s1, s4, cvaacvbb)
    return A


# ---------------------------------------------------------------- spin flip

def _sf_fxc_tensor(ref: Reference, orb_o, orb_v) -> torch.Tensor:
    """ALDA0 SF kernel tensor f_{ia,jb} = sum_g w fxc_sf rho_ia rho_jb with
    rho_ia = phi_i^(occ-spin) phi_a^(vir-spin), over chunks of points."""
    env = ref.env
    fw = sf_kernel_alda0(ref.spec, env.grid_weights, _rho0(ref))
    no, nv = orb_o.shape[1], orb_v.shape[1]
    out = torch.zeros((no * nv, no * nv), dtype=env.dtype, device=env.device)
    ao = env.ao
    for g0 in range(0, ao.shape[1], DENSE_CHUNK):
        g = slice(g0, g0 + DENSE_CHUNK)
        rov = ((ao[0, g] @ orb_o)[:, :, None] * (ao[0, g] @ orb_v)[:, None, :]).reshape(-1, no * nv)
        out.addmm_((fw[g, None] * rov).T, rov)
    return out.reshape(no, nv, no, nv)


def sf_coupling_tensor(ref: Reference, extype: str, method: int = 0) -> torch.Tensor:
    """SF coupling a^{sf}_{ia,jb}: -K + SF xc kernel.

    method: 0 = ALDA0, 1 = multicollinear, 2 = collinear (HF exchange only).
    extype='down': i,j alpha-occ; a,b beta-vir.  extype='up': i,j beta-occ;
    a,b alpha-vir.  No Coulomb J in the spin-flip channels.
    """
    if extype == "down":
        co, cv = _t(ref, ref.orbo_a), _t(ref, ref.orbv_b)
    else:
        co, cv = _t(ref, ref.orbo_b), _t(ref, ref.orbv_a)
    a = -_k_eri(ref, co, cv).permute(0, 2, 1, 3)
    if ref.spec is not None and ref.spec.components:
        if method == 0:
            a = a + _sf_fxc_tensor(ref, co, cv)
        elif method == 1:
            from xtddft_tpu_torch.xc.mcol import sf_kernel_mcol, sf_mcol_tensor

            env = ref.env
            fxcH = sf_kernel_mcol(ref.spec, env.grid_weights, _rho0(ref))
            a = a + sf_mcol_tensor(fxcH, env.ao, co, cv)
    return a


def sf_up_dense(ref: Reference, method: int = 0) -> torch.Tensor:
    """SF-TDA-up CV(b->a) dense matrix, (nc*nv)^2."""
    nc, no, nv = ref.nc, ref.no, ref.nv
    a = sf_coupling_tensor(ref, "up", method)  # (nc, nv, nc, nv)
    faVV = _t(ref, ref.fock_a_mo)[nc + no:, nc + no:]
    fbCC = _t(ref, ref.fock_b_mo)[:nc, :nc]
    A = (_ein("ij,ab->iajb", _eye(ref, nc), faVV)
         - _ein("ij,ab->iajb", fbCC, _eye(ref, nv)) + a)
    return A.reshape(nc * nv, nc * nv)


def sf_down_dense(ref: Reference, method: int = 0) -> torch.Tensor:
    """SF-TDA-down dense matrix in CV|CO|OV|OO layout, dim = (nc+no)(nv+no)."""
    nc, no, nv = ref.nc, ref.no, ref.nv
    a = sf_coupling_tensor(ref, "down", method)  # (nc+no, no+nv, nc+no, no+nv)
    fa = _t(ref, ref.fock_a_mo)
    fb = _t(ref, ref.fock_b_mo)
    I_c, I_o, I_v = _eye(ref, nc), _eye(ref, no), _eye(ref, nv)
    faC = fa[:nc, :nc]
    faO = fa[nc:nc + no, nc:nc + no]
    fbO = fb[nc:nc + no, nc:nc + no]
    fbV = fb[nc + no:, nc + no:]
    faOC = fa[nc:nc + no, :nc]
    fbVO = fb[nc + no:, nc:nc + no]
    dim = (nc + no) * (nv + no)
    d1 = nc * nv
    d2 = d1 + nc * no
    d3 = d2 + no * nv
    s1, s2, s3, s4 = slice(0, d1), slice(d1, d2), slice(d2, d3), slice(d3, dim)
    A = torch.zeros((dim, dim), dtype=ref.env.dtype, device=ref.env.device)

    def sym(r, c, blk):
        A[r, c] = blk
        A[c, r] = blk.T

    A[s1, s1] = (_ein("ij,ab->iajb", I_c, fbV) - _ein("ji,ab->iajb", faC, I_v)
                 + a[:nc, no:, :nc, no:]).reshape(d1, d1)
    A[s2, s2] = (_ein("ij,xy->ixjy", I_c, fbO) - _ein("ji,xy->ixjy", faC, I_o)
                 + a[:nc, :no, :nc, :no]).reshape(nc * no, nc * no)
    A[s3, s3] = (_ein("xy,ab->xayb", I_o, fbV) - _ein("yx,ab->xayb", faO, I_v)
                 + a[nc:, no:, nc:, no:]).reshape(no * nv, no * nv)
    A[s4, s4] = (_ein("uv,tw->utvw", I_o, fbO) - _ein("vu,tw->utvw", faO, I_o)
                 + a[nc:nc + no, :no, nc:nc + no, :no]).reshape(no * no, no * no)
    sym(s1, s2, (_ein("ij,ay->iajy", I_c, fbVO) + a[:nc, no:, :nc, :no]).reshape(d1, nc * no))
    sym(s1, s3, (-_ein("yi,ab->iayb", faOC, I_v) + a[:nc, no:, nc:nc + no, no:]
                 ).reshape(d1, no * nv))
    sym(s2, s3, a[:nc, :no, nc:nc + no, no:].reshape(nc * no, no * nv))
    sym(s1, s4, a[:nc, no:, nc:nc + no, :no].reshape(d1, no * no))
    sym(s2, s4, (-_ein("yi,WZ->iWyZ", faOC, I_o) + a[:nc, :no, nc:nc + no, :no]
                 ).reshape(nc * no, no * no))
    sym(s3, s4, (_ein("yx,aZ->xayZ", I_o, fbVO) + a[nc:, no:, nc:, :no]).reshape(no * nv, no * no))
    return A


def xsf_delta_a(ref: Reference, SA: int = 3, foo: float = 1.0) -> torch.Tensor:
    """Spin-adaptation correction dA for XSF-TDA in the CV|CO|OV|OO layout.

    Only defined for restricted-open references; SA: 0 = none, 1 = diagonal
    blocks only, 2 = + off-diagonal except OO, 3 = full (default for ROKS).
    """
    nc, no, nv = ref.nc, ref.no, ref.nv
    dim = (nc + no) * (nv + no)
    dA = torch.zeros((dim, dim), dtype=ref.env.dtype, device=ref.env.device)
    if SA == 0 or not ref.restricted_open or no == 0:
        return dA
    si = 0.5 * no
    fahf = _t(ref, ref.fock_a_hf_mo)
    fbhf = _t(ref, ref.fock_b_hf_mo)
    fockS = 0.5 * (fbhf - fahf)
    fS_C = fockS[:nc, :nc]
    fS_V = fockS[nc + no:, nc + no:]
    fS_CV = fockS[:nc, nc + no:]
    I_c, I_o, I_v = _eye(ref, nc), _eye(ref, no), _eye(ref, nv)
    mo = _t(ref, ref.mo_a)
    eri = mo_eri(ref.env.eri, mo, mo, mo, mo)
    d1 = nc * nv
    d2 = d1 + nc * no
    d3 = d2 + no * nv
    C = slice(0, nc)
    O = slice(nc, nc + no)
    V = slice(nc + no, None)
    s1, s2, s3, s4 = slice(0, d1), slice(d1, d2), slice(d2, d3), slice(d3, dim)

    def add_sym(r, c, blk):
        dA[r, c] += blk
        dA[c, r] += blk.T

    dA[s1, s1] += ((_ein("ij,ab->iajb", I_c, fS_V) + _ein("ji,ab->iajb", fS_C, I_v))
                   / si).reshape(d1, d1)
    dA[s2, s2] += (_ein("ji,uv->iujv", fS_C, I_o) * 2.0 / (2 * si - 1)
                   - _ein("uijv->iujv", eri[O, C, C, O]) / (2 * si - 1)).reshape(nc * no, nc * no)
    dA[s3, s3] += (_ein("uv,ab->uavb", I_o, fS_V) * 2.0 / (2 * si - 1)
                   - _ein("auvb->uavb", eri[V, O, O, V]) / (2 * si - 1)).reshape(no * nv, no * nv)

    if SA > 1:
        fbhf_VO = fbhf[nc + no:, nc:nc + no]
        fahf_CO = fahf[:nc, nc:nc + no]
        c1 = np.sqrt(1.0 + 1.0 / (2 * si)) - 1.0
        add_sym(s1, s2, (c1 * (_ein("ij,av->iajv", I_c, fbhf_VO)
                               - _ein("avji->iajv", eri[V, O, C, C]))).reshape(d1, nc * no))
        add_sym(s1, s3, (c1 * (-_ein("iv,ab->iavb", fahf_CO, I_v)
                               - _ein("abvi->iavb", eri[V, V, O, C]))).reshape(d1, no * nv))
        add_sym(s2, s3, ((1.0 / (2 * si - 1))
                         * (_ein("uivb->iuvb", eri[O, C, O, V])
                            - _ein("ubvi->iuvb", eri[O, V, O, C]))).reshape(nc * no, no * nv))

    if SA > 2:
        factor = np.sqrt((2 * si + 1) / (2 * si - 1))
        c2 = np.sqrt(2 * si / (2 * si - 1)) - 1.0
        c3 = 1.0 / np.sqrt(2 * si * (2 * si - 1))
        blk = (-(factor - 1.0) * _ein("avwi->iawv", eri[V, O, O, C])
               + (1.0 / si) * factor * _ein("ia,wv->iawv", fS_CV, I_o)).reshape(d1, no * no)
        add_sym(s1, s4, foo * blk)
        fahf_OC = fahf[nc:nc + no, :nc]
        fbhf_CO = fbhf[:nc, nc:nc + no]
        blk = (c2 * (-_ein("wi,uv->iuwv", fahf_OC, I_o) - _ein("uvwi->iuwv", eri[O, O, O, C]))
               + c3 * _ein("iu,wv->iuwv", fbhf_CO, I_o)).reshape(nc * no, no * no)
        add_sym(s2, s4, foo * blk)
        fbhf_VO2 = fbhf[nc + no:, nc:nc + no]
        fahf_OV = fahf[nc:nc + no, nc + no:]
        blk = (c2 * (_ein("wu,av->uawv", I_o, fbhf_VO2) - _ein("avwu->uawv", eri[V, O, O, O]))
               - c3 * _ein("ua,wv->uawv", fahf_OV, I_o)).reshape(no * nv, no * no)
        add_sym(s3, s4, foo * blk)
    return dA


def xsf_dense(ref: Reference, SA: int = 3, foo: float = 1.0, fglobal: float = 1.0,
              method: int = 0, remove: bool = True):
    """XSF-TDA dense matrix = SF-down + fglobal * dA, optionally with the
    Sf=Si contaminant projected out of the OO block.  Returns (A, vects):
    vects is the host OO projector (None if not removed)."""
    A = sf_down_dense(ref, method) + fglobal * xsf_delta_a(ref, SA, foo)
    if not remove or ref.no == 0 or not ref.restricted_open:
        return A, None
    nc, no, nv = ref.nc, ref.no, ref.nv
    d3 = nc * nv + nc * no + no * nv
    vects = sf_oo_projector(no)
    P = _t(ref, vects)
    dim = A.shape[0]
    Ar = torch.zeros((dim - 1, dim - 1), dtype=A.dtype, device=A.device)
    Ar[:d3, :d3] = A[:d3, :d3]
    Ar[:d3, d3:] = A[:d3, d3:] @ P
    Ar[d3:, :d3] = P.T @ A[d3:, :d3]
    Ar[d3:, d3:] = P.T @ A[d3:, d3:] @ P
    return Ar, vects

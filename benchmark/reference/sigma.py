"""Plain reference of the cells' response operators (A z for a block of
trial vectors), in plain torch, from the cell's inputs alone.

Two operators over the density-fitted B[P, p, q] ((pq|rs) = sum_P B[P,p,q]
B[P,r,s]), the MO grid table phi and the MO Fock matrices:

- ``xtda``: spin-conserving X-TDA, alpha (nc+no) x nv rows then beta
  nc x (no+nv), each block  J - hyb K + fxc + F_vv z - z F_oo, plus the
  spin-adaptation coupling of the closed-virtual rows (Li and Liu's X-TDA,
  the terms in the Fock difference dF = F_hf,b - F_hf,a);
- ``xsf``: spin-flip-down XSF-TDA on the (nc+no) x (no+nv) block, in the
  CV | CO | OV | OO layout with the OO block's Sf = Si direction projected
  out, -hyb K + ALDA0 fxc + Fock terms, plus the spin-adaptation terms dA
  at level SA (1-3) from their own small MO tensors.

The exchange contracts B an aux chunk at a time, the grid terms a chunk
of points at a time, so that the whole fits beside the inputs.  Every
product runs under the precision the caller asks for: ``tf32`` lets the
matrix products of an f32 operator round their inputs to TF32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from reference import xc

# aux rows of B and grid points contracted at a time
AUX_CHUNK = 32
GRID_CHUNK = 2048


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def oo_projector(no: int) -> np.ndarray:
    """(no^2, no^2 - 1) orthonormal basis of the OO block with the traceful
    Sf = Si direction removed: the layout of XSF-TDA's compressed OO block
    (the reference program `xtddft/XSF_TDA.py:397-414`, arXiv:2511.16906)."""
    tmp_v = np.zeros((no - 1, no))
    for i in range(1, no):
        row = np.array([no - i] + [-1.0] * (no - i))
        tmp_v[i - 1, i - 1:] = row * (1.0 / np.sqrt((no - i + 1) * (no - i)))
    vects = np.eye(no * no)[:, :-1]
    index = [0] + [i * (no + 1) for i in range(1, no)]
    for i in range(no - 1):
        vects[0::no + 1, index[i]] = tmp_v[i]
    return vects


class Operator:
    """A z of the reference, in ``dtype`` on the inputs' device."""

    def __init__(self, inp, method: str, dtype: torch.dtype, tf32: bool = False, SA: int = 0,
                 remove: bool = True, fglobal: float = 1.0):
        self.inp, self.method, self.dt, self.tf32 = inp, method, dtype, tf32
        self.SA, self.remove, self.fglobal = SA, remove, fglobal
        self.dev = inp.B.device
        self.hyb = xc.hyb(inp.xc)
        nc, no, nv = inp.nc, inp.no, inp.nv
        fa, fb = (np.asarray(f, dtype=np.float64) for f in inp.fock_mo)
        w_s, rho_s, mask = xc.sanitize(self._t(inp.grid_w), tuple(self._t(r) for r in inp.rho0))
        self.mask = mask.to(dtype)
        if method == "xtda":
            self.blocks = ((nc + no, nv), (nc, no + nv))      # (occ, vir) per spin
            self.focks = (self._t(fa), self._t(fb))
            self.dim = sum(o * v for o, v in self.blocks)
            ea, eb = np.diag(fa), np.diag(fb)
            self.hdiag = np.concatenate([
                (ea[nc + no:][None, :] - ea[:nc + no][:, None]).ravel(),
                (eb[nc:][None, :] - eb[:nc][:, None]).ravel()])
            with matmul_precision(tf32):
                self.H = xc.hessian(inp.xc, w_s, rho_s)
            self.spin_adapt = inp.fock_hf_mo is not None and no > 0
            if self.spin_adapt:
                dF = inp.fock_hf_mo[1] - inp.fock_hf_mo[0]
                self.dFV, self.dFC = self._t(dF[nc + no:, nc + no:]), self._t(dF[:nc, :nc])
        elif method == "xsf":
            self.n_o, self.n_v = nc + no, no + nv
            self.f_occ, self.f_vir = self._t(fa[:nc + no, :nc + no]), self._t(fb[nc:, nc:])
            e_full = np.diag(fb)[nc:][None, :] - np.diag(fa)[:nc + no][:, None]
            self.Vp = oo_projector(no) if remove else None
            h_oo = e_full[nc:, :no].ravel()
            if remove:
                h_oo = np.einsum("pq,p,pq->q", self.Vp, h_oo, self.Vp)
            self.hdiag = np.concatenate([e_full[:nc, no:].ravel(), e_full[:nc, :no].ravel(),
                                         e_full[nc:, no:].ravel(), h_oo])
            self.dim = self.hdiag.size
            self.sf_k = xc.sf_alda0(inp.xc, w_s, tuple(self._t(r) for r in inp.rho0), rho_s)
            self.dA_on = SA > 0 and inp.fock_hf_mo is not None and no > 0
            if self.dA_on:
                with matmul_precision(tf32):
                    self.dA = self._delta_a_tensors()
        else:
            raise ValueError(f"method: 'xtda' or 'xsf', got {method!r}")

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.dev).to(self.dt)

    # ---------------------------------------------------------------- apply

    def apply(self, z: torch.Tensor) -> torch.Tensor:
        """(nz, dim) -> (nz, dim), in the operator's dtype."""
        with matmul_precision(self.tf32):
            z = z.to(device=self.dev, dtype=self.dt)
            return self._xtda(z) if self.method == "xtda" else self._xsf(z)

    def _chunks(self):
        B = self.inp.B
        for p0 in range(0, B.shape[0], AUX_CHUNK):
            yield p0, B[p0:p0 + AUX_CHUNK].to(self.dt)

    @staticmethod
    def _exchange(Boo, Bvv, z):
        """sum_P Boo[P,i,j] (sum_b Bvv[P,a,b] z[x,j,b]) -> (nz, o, v)."""
        P, nz, o, v = Boo.shape[0], z.shape[0], z.shape[1], z.shape[2]
        T = torch.matmul(z.reshape(1, nz * o, v), Bvv.transpose(1, 2))      # (P, nz*o, v)
        T = T.reshape(P, nz, o, v).permute(1, 0, 2, 3).reshape(nz, P * o, v)
        return Boo.permute(1, 0, 2).reshape(o, P * o) @ T

    def _xtda(self, zs):
        nz, inp = zs.shape[0], self.inp
        (oa, va), (ob, vb) = self.blocks
        zz = (zs[:, :oa * va].reshape(nz, oa, va), zs[:, oa * va:].reshape(nz, ob, vb))
        t = torch.zeros((nz, inp.naux), dtype=self.dt, device=self.dev)
        K = [torch.zeros_like(z) for z in zz]
        for p0, Bc in self._chunks():
            for s, (o, v) in enumerate(self.blocks):
                t[:, p0:p0 + Bc.shape[0]] += zz[s].reshape(nz, o * v) @ \
                    Bc[:, :o, o:].reshape(Bc.shape[0], o * v).T
                K[s] += self._exchange(Bc[:, :o, :o], Bc[:, o:, o:], zz[s])
        v1 = [-self.hyb * k for k in K]
        for p0, Bc in self._chunks():
            for s, (o, v) in enumerate(self.blocks):
                v1[s] += (t[:, p0:p0 + Bc.shape[0]] @ Bc[:, :o, o:].reshape(Bc.shape[0], o * v)
                          ).reshape(nz, o, v)
        fx = self._fxc(zz)
        for s, (o, v) in enumerate(self.blocks):
            F = self.focks[s]
            v1[s] += fx[s] + zz[s] @ F[o:, o:].T - F[:o, :o] @ zz[s]
        if self.spin_adapt:
            self._spin_adapt(zz, v1)
        return torch.cat([v.reshape(nz, -1) for v in v1], dim=1)

    def _spin_adapt(self, zz, v1):
        """X-TDA's coupling of the alpha closed-virtual and beta
        closed-virtual rows through dF (spin s = no / 2)."""
        nc, no = self.inp.nc, self.inp.no
        si = 0.5 * no
        r = np.sqrt((si + 1) / si)
        f1, f2, fx = 0.5 * (1.0 - r + 1.0 / (2 * si)), 0.5 * (-1.0 + r + 1.0 / (2 * si)), 0.5 / (2 * si)
        va_ = zz[0].shape[2]
        zac, zbv = zz[0][:, :nc, :], zz[1][:, :, -va_:]
        dFV, dFC = self.dFV, self.dFC
        v1[0][:, :nc, :] += (f1 * (zac @ dFV.T) + f2 * (dFC @ zac)
                             - fx * (zbv @ dFV.T + dFC @ zbv))
        v1[1][:, :, -va_:] += (f2 * (zbv @ dFV.T) + f1 * (dFC @ zbv)
                               - fx * (zac @ dFV.T + dFC @ zac))

    def _fxc(self, zz):
        """The GGA response through the grid: the transition densities and
        their gradients, the per-point Hessian, the back-projection."""
        nz, phi = zz[0].shape[0], self.inp.phi
        out = [torch.zeros_like(z) for z in zz]
        for g0 in range(0, phi.shape[1], GRID_CHUNK):
            g = slice(g0, g0 + GRID_CHUNK)
            ph = phi[:, g].to(self.dt)                       # (4, G, nmo)
            d, parts = [], []
            for s, (o, v) in enumerate(self.blocks):
                po, pv = ph[:, :, :o].transpose(1, 2), ph[:, :, o:].transpose(1, 2)  # (4, o|v, G)
                tmp = zz[s] @ pv[0]                                                   # (nz, o, G)
                u = zz[s].transpose(1, 2) @ po[0]                                     # (nz, v, G)
                r0 = (tmp * po[0]).sum(1)
                gr = torch.stack([(tmp * po[y]).sum(1) + (u * pv[y]).sum(1) for y in (1, 2, 3)], 1)
                d.append((r0, gr))
                parts.append((po, pv))
            m = self.mask[g]
            drho = torch.cat([d[0][0][:, None], d[1][0][:, None], d[0][1], d[1][1]], 1) * m
            dv = torch.einsum("ijg,xjg->xig", self.H[:, :, g], drho)   # (nz, 8, G)
            for s, (po, pv) in enumerate(parts):
                dwv = dv[:, s]
                dwg = dv[:, 2 + 3 * s:5 + 3 * s]
                F0 = dwv[:, None] * po[0] + sum(dwg[:, y - 1, None] * po[y] for y in (1, 2, 3))
                out[s] += F0 @ pv[0].T
                for y in (1, 2, 3):
                    out[s] += (dwg[:, y - 1, None] * po[0]) @ pv[y].T
        return out

    # ------------------------------------------------------------------ xsf

    def _xsf(self, zs):
        inp, nz = self.inp, zs.shape[0]
        nc, no, nv = inp.nc, inp.no, inp.nv
        d1, d2, d3 = nc * nv, nc * nv + nc * no, nc * nv + nc * no + no * nv
        zcv = zs[:, :d1].reshape(nz, nc, nv)
        zco = zs[:, d1:d2].reshape(nz, nc, no)
        zov = zs[:, d2:d3].reshape(nz, no, nv)
        vp = self._t(self.Vp) if self.remove else None
        zoo = (zs[:, d3:] @ vp.T if self.remove else zs[:, d3:]).reshape(nz, no, no)
        z = torch.zeros((nz, self.n_o, self.n_v), dtype=self.dt, device=self.dev)
        z[:, :nc, no:], z[:, :nc, :no], z[:, nc:, no:], z[:, nc:, :no] = zcv, zco, zov, zoo
        vs = z @ self.f_vir.T - self.f_occ @ z
        if self.hyb != 0.0:
            K = torch.zeros_like(z)
            for _, Bc in self._chunks():
                K += self._exchange(Bc[:, :self.n_o, :self.n_o], Bc[:, nc:, nc:], z)
            vs = vs - self.hyb * K
        phi = inp.phi
        for g0 in range(0, phi.shape[1], GRID_CHUNK):
            g = slice(g0, g0 + GRID_CHUNK)
            p0 = phi[0, g].to(self.dt)
            po, pv = p0[:, :self.n_o].T, p0[:, nc:].T                     # (o|v, G)
            rho1 = ((z @ pv) * po).sum(1)                                 # (nz, G)
            vs += ((self.sf_k[g] * rho1)[:, None] * po) @ pv.T
        if self.dA_on:
            parts = apply_delta_a(self.dA, 0.5 * no, self.SA, zcv, zco, zov, zoo)
            for (rows, cols), dpart in zip(((slice(None, nc), slice(no, None)),
                                             (slice(None, nc), slice(None, no)),
                                             (slice(nc, None), slice(no, None)),
                                             (slice(nc, None), slice(None, no))), parts):
                vs[:, rows, cols] += self.fglobal * dpart
        ooo = vs[:, nc:, :no].reshape(nz, -1)
        if self.remove:
            ooo = ooo @ vp
        return torch.cat([vs[:, :nc, no:].reshape(nz, -1), vs[:, :nc, :no].reshape(nz, -1),
                          vs[:, nc:, no:].reshape(nz, -1), ooo], dim=1)

    def _delta_a_tensors(self) -> dict:
        """The dA terms' MO tensors (pq|rs) = sum_P B[P,p,q] B[P,r,s], each
        with two or more open-shell indices, and the HF Fock blocks."""
        inp = self.inp
        nc, no = inp.nc, inp.no
        C, O, V = slice(0, nc), slice(nc, nc + no), slice(nc + no, None)
        want = {"e_OCCO": (O, C, C, O), "e_VOOV": (V, O, O, V)}
        if self.SA > 1:
            want.update(e_VOCC=(V, O, C, C), e_VVOC=(V, V, O, C), e_OCOV=(O, C, O, V),
                        e_OVOC=(O, V, O, C))
        if self.SA > 2:
            want.update(e_VOOC=(V, O, O, C), e_OOOC=(O, O, O, C), e_VOOO=(V, O, O, O))
        T = {k: 0.0 for k in want}
        for _, Bc in self._chunks():
            for k, (s1, s2, s3, s4) in want.items():
                T[k] = T[k] + torch.einsum("Ppq,Prs->pqrs", Bc[:, s1, s2], Bc[:, s3, s4])
        fahf, fbhf = (self._t(f) for f in inp.fock_hf_mo)
        fS = 0.5 * (fbhf - fahf)
        T.update(fS_C=fS[C, C], fS_V=fS[V, V], fS_CV=fS[C, V], fbhf_VO=fbhf[V, O],
                 fahf_CO=fahf[C, O], fahf_OC=fahf[O, C], fbhf_CO=fbhf[C, O], fahf_OV=fahf[O, V])
        return T


def apply_delta_a(T, si, SA, zcv, zco, zov, zoo):
    """(dcv, dco, dov, doo): XSF-TDA's spin-adaptation couplings of the four
    blocks at level SA (arXiv:2511.16906), from the tensors T."""
    e = torch.einsum
    no = zoo.shape[-1]
    c1 = float(np.sqrt(1.0 + 1.0 / (2 * si)) - 1.0)
    c2 = float(np.sqrt(2 * si / (2 * si - 1)) - 1.0)
    c3 = float(1.0 / np.sqrt(2 * si * (2 * si - 1)))
    fac = float(np.sqrt((2 * si + 1) / (2 * si - 1)))
    k = 1.0 / (2 * si - 1)
    eye = torch.eye(no, dtype=zoo.dtype, device=zoo.device)
    dcv = (e("ab,xib->xia", T["fS_V"], zcv) + e("ji,xja->xia", T["fS_C"], zcv)) / si
    dco = 2.0 * k * e("ji,xju->xiu", T["fS_C"], zco) - k * e("uijv,xjv->xiu", T["e_OCCO"], zco)
    dov = 2.0 * k * e("ab,xub->xua", T["fS_V"], zov) - k * e("auvb,xvb->xua", T["e_VOOV"], zov)
    doo = torch.zeros_like(zoo)
    if SA > 1:
        dcv = dcv + c1 * (e("av,xiv->xia", T["fbhf_VO"], zco) - e("avji,xjv->xia", T["e_VOCC"], zco)
                          - e("iv,xva->xia", T["fahf_CO"], zov)
                          - e("abvi,xvb->xia", T["e_VVOC"], zov))
        dco = dco + c1 * (e("av,xia->xiv", T["fbhf_VO"], zcv) - e("avji,xia->xjv", T["e_VOCC"], zcv))
        dov = dov + c1 * (-e("iv,xia->xva", T["fahf_CO"], zcv) - e("abvi,xib->xva", T["e_VVOC"], zcv))
        dco = dco + k * (e("uivb,xvb->xiu", T["e_OCOV"], zov) - e("ubvi,xvb->xiu", T["e_OVOC"], zov))
        dov = dov + k * (e("uivb,xiu->xvb", T["e_OCOV"], zco) - e("ubvi,xiu->xvb", T["e_OVOC"], zco))
    if SA > 2:
        dcv = dcv + (-(fac - 1.0) * e("avwi,xwv->xia", T["e_VOOC"], zoo)
                           + (fac / si) * e("ia,xww->xia", T["fS_CV"], zoo))
        doo = doo + (-(fac - 1.0) * e("avwi,xia->xwv", T["e_VOOC"], zcv)
                           + (fac / si) * e("ia,xia,wv->xwv", T["fS_CV"], zcv, eye))
        dco = dco + (c2 * (-e("wi,xwu->xiu", T["fahf_OC"], zoo)
                                 - e("uvwi,xwv->xiu", T["e_OOOC"], zoo))
                           + c3 * e("iu,xww->xiu", T["fbhf_CO"], zoo))
        doo = doo + (c2 * (-e("wi,xiv->xwv", T["fahf_OC"], zco)
                                 - e("uvwi,xiu->xwv", T["e_OOOC"], zco))
                           + c3 * e("iu,xiu,wv->xwv", T["fbhf_CO"], zco, eye))
        dov = dov + (c2 * (e("av,xuv->xua", T["fbhf_VO"], zoo)
                                 - e("avwu,xwv->xua", T["e_VOOO"], zoo))
                           - c3 * e("ua,xww->xua", T["fahf_OV"], zoo))
        doo = doo + (c2 * (e("av,xwa->xwv", T["fbhf_VO"], zov)
                                 - e("avwu,xua->xwv", T["e_VOOO"], zov))
                           - c3 * e("ua,xua,wv->xwv", T["fahf_OV"], zov, eye))
    return dcv, dco, dov, doo

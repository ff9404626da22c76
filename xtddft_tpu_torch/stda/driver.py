"""sTDA method driver (sX-TDA spin-adapted, sU-TDA unrestricted).

Counterpart of the JAX package's `stda/driver.py` (the reference's `OSsTDA`,
`xtddft/sTDA/os_sTDA.py:353`): the CAS energy window, P-CSF selection below
``Emax``, perturbative S-CSF selection at threshold ``tp``, the truncated A
assembled and diagonalized on the device (f64), and oscillator and rotatory
strengths and <dS^2> over the selected CSF space on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from xtddft_tpu_torch import units
from xtddft_tpu_torch.methods.drivers import ExcitationResult, _ref_of
from xtddft_tpu_torch.stda import core


class STDA:
    """Simplified TDA for open-shell references.

    Parameters as the reference's (`os_sTDA.py:354`):
      spinadapt: sX-TDA on a ROKS/ROHF reference (default: auto) vs sU-TDA
      Emax:      P-CSF energy window in eV (None/0 disables truncation)
      tp:        S-CSF perturbative threshold (hartree)
      cas:       CAS orbital energy-window pre-truncation
      union:     force CV(aa)/CV(bb) to share one CSF index set
      correct:   diagonal exchange 'velocity correction' term
      paramtype: 'os' (open-shell) or 'cs' (Grimme) gamma parameters

    After ``kernel``: ``timings`` (seconds per stage), ``selection`` (the
    P-CSF and final counts per block, the selected and full dimensions),
    ``act``, ``ctx``, ``sel``, ``e`` and ``v``."""

    def __init__(self, mf, spinadapt: bool | None = None, Emax: float | None = 10.0,
                 tp: float = 1e-4, cas: bool = True, nstates: int = 10,
                 union: bool = True, correct: bool = False,
                 paramtype: str = "os", sa_cross_sign: float = -1.0,
                 select_with_fock: bool = True):
        self.ref = _ref_of(mf)
        self.spinadapt = spinadapt if spinadapt is not None else self.ref.restricted_open
        if self.spinadapt and not self.ref.restricted_open:
            raise ValueError("spinadapt=True requires a ROKS/ROHF reference")
        self.Emax = Emax
        self.tp = tp
        self.cas = cas
        self.nstates = nstates
        self.union = union
        self.correct = correct
        self.paramtype = paramtype
        self.sa_cross_sign = sa_cross_sign
        self.select_with_fock = select_with_fock
        self.timings: dict = {}
        self.selection: dict = {}

    def kernel(self) -> ExcitationResult:
        t_all0 = time.perf_counter()
        ref = self.ref
        t0 = time.perf_counter()
        act = core.select_active_space(ref, self.Emax or 10.0, ref.hyb,
                                       cas=self.cas and bool(self.Emax))
        ctx = core.make_context(ref, act, self.spinadapt, self.paramtype)
        self.act = act
        self.ctx = ctx
        self.timings["setup"] = time.perf_counter() - t0
        full = core.full_csf_set(act.nc, act.no, act.nv)
        sel = self._select(ctx, full) if self.Emax else full
        self.sel = sel

        t0 = time.perf_counter()
        A = core.assemble_A(ctx, sel, self.correct, self.sa_cross_sign)
        if A.is_cuda:
            torch.cuda.synchronize()
        self.timings["assemble"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        e, v = torch.linalg.eigh(A)
        n = min(self.nstates, e.shape[0])
        e, v = e[:n].cpu().numpy(), v[:, :n].cpu().numpy()
        self.timings["diag"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        osc = self._osc_str(e, v)
        rot = self._rot_str(e, v)
        ds2 = self._delta_s2(v)
        self.timings["props"] = time.perf_counter() - t0
        self.timings["total"] = time.perf_counter() - t_all0
        self.e = e
        self.v = v
        return ExcitationResult(e=e, v=v, osc=osc, rot=rot, ds2=ds2, solver="stda")

    def _select(self, ctx: core.STDAContext, full: core.CSFSet) -> core.CSFSet:
        nc, no, nv = ctx.nc, ctx.no, ctx.nv
        t0 = time.perf_counter()
        iaia, _ = core.csf_diagonal(ctx, full, self.correct)
        sizes = [nc * nv, no * nv, nc * no, nc * nv]
        offs = np.cumsum([0] + sizes)
        by_block = {b: iaia[offs[k]:offs[k + 1]].reshape(-1) for k, b in enumerate(core.BLOCKS)}
        shapes = {"cva": (nc, nv), "ova": (no, nv), "cob": (nc, no), "cvb": (nc, nv)}
        p_idx, n_idx = {}, {}
        for b in core.BLOCKS:
            grid_i, grid_a = full.idx[b]
            keep = by_block[b] * units.HA2EV <= self.Emax
            p_idx[b] = (grid_i[keep], grid_a[keep])
            n_idx[b] = (grid_i[~keep], grid_a[~keep])
        if self.union:
            pu = core.union_ia(*p_idx["cva"], *p_idx["cvb"], nv)
            nu = core.intersect_ia(*n_idx["cva"], *n_idx["cvb"], nv)
            p_idx["cva"] = p_idx["cvb"] = pu
            n_idx["cva"] = n_idx["cvb"] = nu
        pcsf = core.CSFSet(idx=p_idx)
        ncsf = core.CSFSet(idx=n_idx)

        def _vals(cset):
            return np.concatenate([by_block[b].reshape(shapes[b])[cset.idx[b]]
                                   for b in core.BLOCKS])

        self.timings["pcsf"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        keep_n, self.scsf_couplings = core.perturbative_selection(
            ctx, pcsf, ncsf, _vals(pcsf), _vals(ncsf), self.tp,
            select_with_fock=self.select_with_fock, sa_cross_sign=self.sa_cross_sign)
        self.timings["scsf"] = time.perf_counter() - t0

        # merge P and the kept S per block, in (i, a) row-major order
        sel_idx = {}
        off = 0
        for b in core.BLOCKS:
            ni, na = ncsf.idx[b]
            m = keep_n[off:off + len(ni)]
            off += len(ni)
            i = np.concatenate([pcsf.idx[b][0], ni[m]])
            a = np.concatenate([pcsf.idx[b][1], na[m]])
            sel_idx[b] = core._sort_ia(i, a, shapes[b][1])
        if self.union:
            u = core.union_ia(*sel_idx["cva"], *sel_idx["cvb"], nv)
            sel_idx["cva"] = sel_idx["cvb"] = u
        sel = core.CSFSet(idx=sel_idx)
        self.selection = {"pcsf": pcsf.sizes, "final": sel.sizes, "dim_full": full.dim,
                          "dim": sel.dim}
        return sel

    def _mo_prop(self, ints_ao):
        """Per-spin (3, nocc_s, nvir_s) MO blocks of a one-electron AO
        operator (a tensor on the Env's device) over the active window,
        transformed there; host arrays."""
        env = self.ref.env
        sl = slice(self.act.lo, self.act.hi)
        out = []
        for mo, nocc in ((self.ref.mo_a, self.act.nc + self.act.no), (self.ref.mo_b, self.act.nc)):
            c = env.tensor(mo[:, sl])
            out.append(torch.einsum("xpq,pi,qa->xia", ints_ao, c[:, :nocc], c[:, nocc:])
                       .cpu().numpy())
        return out

    def _gather_prop(self, da, db):
        """(3, P) operator values over the selected CSFs."""
        occ, vir, spin = self.sel.gather_arrays(self.act.nc, self.act.no)
        out = np.zeros((3, len(occ)))
        mask_a = spin == 0
        mask_b = ~mask_a
        out[:, mask_a] = da[:, occ[mask_a], vir[mask_a]]
        out[:, mask_b] = db[:, occ[mask_b], vir[mask_b]]
        return out

    def _osc_str(self, e, v):
        d = self._gather_prop(*self._mo_prop(self.ref.env.dip))
        td = np.einsum("xp,ps->sx", d, v)
        return (2.0 / 3.0) * e * np.einsum("sx,sx->s", td, td)

    def _rot_str(self, e, v):
        de = self._gather_prop(*self._mo_prop(self.ref.env.ipovlp))
        dm = self._gather_prop(*self._mo_prop(self.ref.env.rxp))
        t_e = -np.einsum("xp,ps->sx", de, v)
        t_m = 0.5 * np.einsum("xp,ps->sx", dm, v)
        return np.einsum("s,sx,sx->s", 1.0 / e, t_e, t_m) / units.CGS2AU

    def _delta_s2(self, v):
        """<dS^2> over the selected CSFs (`os_sTDA.py:1335-1400`)."""
        nstates = v.shape[1]
        nc, no, nv = self.act.nc, self.act.no, self.act.nv
        szs = self.sel.sizes
        o1 = szs["cva"]
        o2 = o1 + szs["ova"]
        o3 = o2 + szs["cob"]
        x_cva = v[:o1, :].T
        x_ova = v[o1:o2, :].T
        x_cob = v[o2:o3, :].T
        x_cvb = v[o3:, :].T
        if self.spinadapt:
            # CV(aa)/CV(bb) share one index set under union; align by key
            i1, a1 = self.sel.idx["cva"]
            i2, a2 = self.sel.idx["cvb"]
            if len(i1) == len(i2) and np.array_equal(i1, i2) and np.array_equal(a1, a2):
                xa, xb = x_cva, x_cvb
            else:
                _, c1, c2 = np.intersect1d(i1 * nv + a1, i2 * nv + a2, return_indices=True)
                xa, xb = x_cva[:, c1], x_cvb[:, c2]
            return (np.einsum("sp,sp->s", x_cva, x_cva) + np.einsum("sp,sp->s", x_cvb, x_cvb)
                    - 2.0 * np.einsum("sp,sp->s", xa, xb))
        # the UKS path: the full overlap-matrix expression
        ref = self.ref
        sl = slice(self.act.lo, self.act.hi)
        nocc_a, nocc_b = nc + no, nc
        mo_a = ref.mo_a[:, sl]
        mo_b = ref.mo_b[:, sl]
        oa, va = mo_a[:, :nocc_a], mo_a[:, nocc_a:]
        ob, vb = mo_b[:, :nocc_b], mo_b[:, nocc_b:]
        S = ref.env.S.cpu().numpy()
        Sccba = np.einsum("pq,pi,qj->ij", S, ob, oa)
        Sccab = Sccba.T
        Svcab = np.einsum("pq,pi,qj->ij", S, va, ob)
        Svcba = np.einsum("pq,pi,qj->ij", S, vb, oa)
        Svvab = np.einsum("pq,pi,qj->ij", S, va, vb)

        def scatter(x, idx, shape):
            out = np.zeros((nstates,) + shape)
            out[:, idx[0], idx[1]] = x
            return out

        xcv_a = scatter(x_cva, self.sel.idx["cva"], (nc, nv))
        xov_a = scatter(x_ova, self.sel.idx["ova"], (no, nv))
        xco_b = scatter(x_cob, self.sel.idx["cob"], (nc, no))
        xcv_b = scatter(x_cvb, self.sel.idx["cvb"], (nc, nv))

        def ein(spec, *ops):
            return np.einsum(spec, *ops, optimize=True)

        return (
            ein("nia,nja,ki,jk->n", xcv_a, xcv_a, Sccba[:, :nc], Sccba.T[:nc, :])
            + ein("nia,nja,ki,jk->n", xov_a, xov_a, Sccba[:, nc:], Sccba.T[nc:, :])
            + ein("nia,nja,ki,jk->n", xov_a, xcv_a, Sccba[:, nc:], Sccba.T[:nc, :])
            + ein("nia,nja,ki,jk->n", xcv_a, xov_a, Sccba[:, :nc], Sccba.T[nc:, :])
            - ein("nia,nib,ak,kb->n", xcv_a, xcv_a, Svcab, Svcab.T)
            - ein("nia,nib,ak,kb->n", xov_a, xov_a, Svcab, Svcab.T)
            + ein("nia,nja,ki,jk->n", xcv_b, xcv_b, Sccab, Sccab.T)
            + ein("nia,nja,ki,jk->n", xco_b, xco_b, Sccab, Sccab.T)
            - ein("nia,nib,ak,kb->n", xco_b, xco_b, Svcba[:no, :], Svcba.T[:, :no])
            - ein("nia,nib,ak,kb->n", xcv_b, xcv_b, Svcba[no:, :], Svcba.T[:, no:])
            - ein("nia,nib,ak,kb->n", xco_b, xcv_b, Svcba[:no, :], Svcba.T[:, no:])
            - ein("nia,nib,ak,kb->n", xcv_b, xco_b, Svcba[no:, :], Svcba.T[:, :no])
            - 2 * ein("nia,njb,ji,ab->n", xcv_a, xcv_b, Sccba[:, :nc], Svvab[:, no:])
            - 2 * ein("nia,njb,ji,ab->n", xcv_a, xco_b, Sccba[:, :nc], Svvab[:, :no])
            - 2 * ein("nia,njb,ji,ab->n", xov_a, xcv_b, Sccba[:, nc:], Svvab[:, no:])
            - 2 * ein("nia,njb,ji,ab->n", xov_a, xco_b, Sccba[:, nc:], Svvab[:, :no]))

    def summary(self, result: ExcitationResult | None = None) -> str:
        """Per-stage timing and the excitation table (the reference prints
        the same, `os_sTDA.py:1294-1332`)."""
        lines = [f"{'sX-TDA' if self.spinadapt else 'sU-TDA'} results"]
        if result is not None:
            lines.append(f'{"num":>4} {"energy":>8} {"wav_len":>9} {"osc_str":>8} '
                         f'{"rot_str":>8} {"deltaS2":>8}')
            for k in range(len(result.e)):
                ev = result.e[k] * units.HA2EV
                lines.append(
                    f"{k + 1:4d} {ev:8.4f} {units.EV_X_NM / ev:9.4f} "
                    f"{result.osc[k]:8.4f} {result.rot[k]:8.4f} "
                    f"{(result.ds2[k] if result.ds2 is not None else 0.0):8.4f}")
        if self.selection:
            lines.append(f"selected dim {self.selection['dim']} / {self.selection['dim_full']}")
        for k, val in self.timings.items():
            lines.append(f"{k:<10} {val:8.4f} s")
        return "\n".join(lines)

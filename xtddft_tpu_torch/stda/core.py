"""Simplified-TDA (sTDA) engine: monopole gamma kernels, Löwdin transition
charges, CSF selection and the assembly of the truncated A matrix.

Counterpart of the JAX package's `stda/core.py`.  Every coupling block is a
contraction over the atom axis: the exchange type

    K[p,q] = sum_AB qk[A,p] gammaK[A,B] qk[B,q]

is a plain matrix product on the device, and the Coulomb type
J[p,q] = sum_A g_oo[A,o_p,o_q] qvv[A,v_p,v_q] (g_oo = gammaJ . q_oo) is the
hand-written gather-reduce K4 (`kernels/stda_coupling.py`), which forms
nothing of size (atoms, rows, columns).  The data-dependent index selection
stays on the host in numpy.

Physics (the reference's `xtddft/sTDA/os_sTDA.py`): Mataga-Nishimoto-like
atom-pair Coulomb and exchange kernels with 'os' (open-shell) or 'cs'
(Grimme) parameters; Löwdin monopole transition charges from S^(1/2) C; the
excitation space CV(aa)|OV(aa)|CO(bb)|CV(bb) with exchange-type coupling
everywhere and Coulomb-type coupling and the Fock terms between same-spin
CSFs; the spin-adapted corrections from the HF-flavored Fock pair with the
X-TDA factors (the CV(aa)-CV(bb) cross term with X-TDA's sign, as in the JAX
package).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from xtddft_tpu_torch import units
from xtddft_tpu_torch.kernels.stda_coupling import j_block, j_diagonal
from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.stda.hardness import eta_per_atom

BLOCKS = ("cva", "ova", "cob", "cvb")


def gamma_jk(mol, hyb: float, paramtype: str = "os"):
    """Atom-pair Coulomb (gJ) and exchange (gK) kernels, (natm, natm) host
    arrays in hartree (`os_sTDA.py:408-433`)."""
    r = mol.coords
    R = np.linalg.norm(r[:, None, :] - r[None, :, :], axis=-1)
    # per-element hardness: 2*eta/ha2eV, pair-averaged (stda convention)
    eta = 2.0 * eta_per_atom(mol.symbols) / units.HA2EV
    eta_pair = 0.5 * (eta[:, None] + eta[None, :])
    if paramtype == "cs":
        beta = 0.20 + hyb * 1.83
        gj = (1.0 / (R**beta + (hyb * eta_pair) ** (-beta))) ** (1.0 / beta)
    elif paramtype == "os":
        beta = hyb + 0.3
        gj = (1.0 / (R**beta + (1.4 * hyb * eta_pair) ** (-beta))) ** (1.0 / beta)
    else:
        raise ValueError(f"unknown paramtype {paramtype!r}")
    alpha = 1.42 + hyb * 0.48
    gk = (1.0 / (R**alpha + eta_pair ** (-alpha))) ** (1.0 / alpha)
    return gj, gk


def lowdin_charges(env, C_occ, C_vir):
    """Löwdin monopole charges per atom, qk[A,i,a], qj_oo[A,i,j] and
    qj_vv[A,a,b], from C' = S^(1/2) C (`os_sTDA.py:637-670`), as tensors on
    the Env's device."""
    S = env.S.cpu().numpy()
    w, U = np.linalg.eigh(S)
    S_half = (U * np.sqrt(w)) @ U.T
    M = np.zeros((env.mol.natm, env.nao))
    M[env.layout.ao_atoms, np.arange(env.nao)] = 1.0
    Co = env.tensor(S_half @ C_occ)
    Cv = env.tensor(S_half @ C_vir)
    Mt = env.tensor(M)
    qk = torch.einsum("mu,ui,ua->mia", Mt, Co, Cv)
    qj_oo = torch.einsum("mu,ui,uj->mij", Mt, Co, Co)
    qj_vv = torch.einsum("mu,ua,ub->mab", Mt, Cv, Cv)
    return qk, qj_oo, qj_vv


@dataclasses.dataclass
class STDAContext:
    """What the truncated sTDA couplings need, per spin, in the (possibly
    CAS-truncated) active space; tensors on the Env's device."""

    nc: int
    no: int
    nv: int
    spinadapt: bool
    si: float
    gj: torch.Tensor  # (natm, natm)
    gk: torch.Tensor
    # per spin s in (alpha, beta): charges over (occ_s x vir_s)
    qk: tuple  # qk[s][A, o, v]
    qj_oo: tuple
    qj_vv: tuple
    g_oo: tuple  # gJ . qj_oo[s], the occupied table of K4
    fock_occ: tuple  # fock_occ[s] (nocc_s, nocc_s)
    fock_vir: tuple
    # spin-adaptation ingredients (None unless spinadapt), host arrays
    dFC: np.ndarray | None = None  # (nc, nc) HF-Fock spin difference, core
    dFV: np.ndarray | None = None  # (nv, nv) ... common virtual block

    @property
    def nocc(self):
        return (self.nc + self.no, self.nc)

    @property
    def nvir(self):
        return (self.nv, self.no + self.nv)


@dataclasses.dataclass(frozen=True)
class ActiveSpace:
    """CAS energy-window truncation (`os_sTDA.py:505-578`): a contiguous
    orbital slice [lo, hi) around the open shell in c|o|v ordering."""

    lo: int
    hi: int
    nc: int
    no: int
    nv: int


def select_active_space(ref: Reference, Emax: float, hyb: float,
                        cas: bool = True) -> ActiveSpace:
    nc, no, nv = ref.nc, ref.no, ref.nv
    if not cas or no == 0:
        return ActiveSpace(0, nc + no + nv, nc, no, nv)
    ea = np.diag(ref.fock_a_mo)
    eb = np.diag(ref.fock_b_mo)
    somo_lo, somo_hi = ea[nc:nc + no].min(), ea[nc:nc + no].max()
    sumo_lo, sumo_hi = eb[nc:nc + no].min(), eb[nc:nc + no].max()
    deps = (1.0 + 0.8 * hyb) * Emax / units.HA2EV
    othr_a, vthr_a = somo_lo - 2 * deps, somo_hi + 2 * deps
    othr_b, vthr_b = sumo_lo - 2 * deps, sumo_hi + 2 * deps
    nc_a = int(np.count_nonzero((ea[:nc] > othr_a) & (ea[:nc] < somo_lo)))
    nc_b = int(np.count_nonzero((eb[:nc] > othr_b) & (eb[:nc] < sumo_lo)))
    nc_act = max(nc_a, nc_b)
    va = ea[nc + no:]
    vb = eb[nc + no:]
    nv_a = int(np.count_nonzero((va < vthr_a) & (va > somo_hi)))
    nv_b = int(np.count_nonzero((vb < vthr_b) & (vb > sumo_hi)))
    nv_act = max(nv_a, nv_b)
    return ActiveSpace(nc - nc_act, nc + no + nv_act, nc_act, no, nv_act)


def make_context(ref: Reference, act: ActiveSpace, spinadapt: bool,
                 paramtype: str = "os") -> STDAContext:
    env = ref.env
    gj, gk = gamma_jk(env.mol, ref.hyb, paramtype)
    nc, no, nv = act.nc, act.no, act.nv
    sl = slice(act.lo, act.hi)
    mo_a = ref.mo_a[:, sl]
    mo_b = ref.mo_b[:, sl]
    nocc_a, nocc_b = nc + no, nc
    qk_a, qjoo_a, qjvv_a = lowdin_charges(env, mo_a[:, :nocc_a], mo_a[:, nocc_a:])
    qk_b, qjoo_b, qjvv_b = lowdin_charges(env, mo_b[:, :nocc_b], mo_b[:, nocc_b:])
    fa = env.tensor(ref.fock_a_mo[sl, sl])
    fb = env.tensor(ref.fock_b_mo[sl, sl])
    dFC = dFV = None
    if spinadapt:
        dF = ref.fock_b_hf_mo[sl, sl] - ref.fock_a_hf_mo[sl, sl]
        dFC = dF[:nc, :nc]
        dFV = dF[nc + no:, nc + no:]
    gj_t, gk_t = env.tensor(gj), env.tensor(gk)
    return STDAContext(
        nc=nc, no=no, nv=nv, spinadapt=spinadapt, si=0.5 * ref.no,
        gj=gj_t, gk=gk_t, qk=(qk_a, qk_b), qj_oo=(qjoo_a, qjoo_b), qj_vv=(qjvv_a, qjvv_b),
        g_oo=tuple(torch.einsum("AB,Bij->Aij", gj_t, q).contiguous() for q in (qjoo_a, qjoo_b)),
        fock_occ=(fa[:nocc_a, :nocc_a], fb[:nocc_b, :nocc_b]),
        fock_vir=(fa[nocc_a:, nocc_a:], fb[nocc_b:, nocc_b:]),
        dFC=dFC, dFV=dFV)


def sa_factors(si: float):
    """X-TDA's S-dependent spin-adaptation factors (`xtddft/XTDA.py:298-307`)."""
    f1 = 0.5 * (1.0 - np.sqrt((si + 1.0) / si) + 1.0 / (2.0 * si))
    f2 = 0.5 * (-1.0 + np.sqrt((si + 1.0) / si) + 1.0 / (2.0 * si))
    fx = -0.5 / (2.0 * si)
    return f1, f2, fx


@dataclasses.dataclass
class CSFSet:
    """Selected CSFs per block: (i, a) arrays in block-local index space
    (CV: core x common virtual; OV: open x common virtual; CO: core x open)."""

    idx: dict  # block -> (i_arr, a_arr)

    def count(self, block: str) -> int:
        return len(self.idx[block][0])

    @property
    def sizes(self):
        return {b: self.count(b) for b in BLOCKS}

    @property
    def dim(self) -> int:
        return sum(self.count(b) for b in BLOCKS)

    def gather_arrays(self, nc: int, no: int):
        """Concatenated within-spin (occ, vir) index arrays and spin flags in
        the blocked order CVa|OVa|COb|CVb."""
        occ, vir, spin = [], [], []
        for b in BLOCKS:
            i, a = self.idx[b]
            occ.append(nc + i if b == "ova" else i)
            vir.append(no + a if b == "cvb" else a)
            spin.append(np.full(len(i), 0 if b in ("cva", "ova") else 1, dtype=np.int64))
        return (np.concatenate(occ).astype(np.int64), np.concatenate(vir).astype(np.int64),
                np.concatenate(spin))


def full_csf_set(nc: int, no: int, nv: int) -> CSFSet:
    def grid(n1, n2):
        i, a = np.indices((n1, n2))
        return i.ravel(), a.ravel()

    return CSFSet(idx={"cva": grid(nc, nv), "ova": grid(no, nv), "cob": grid(nc, no),
                       "cvb": grid(nc, nv)})


def _sort_ia(i, a, n2):
    order = np.argsort(i * n2 + a, kind="stable")
    return i[order], a[order]


def union_ia(i1, a1, i2, a2, n2):
    key = np.union1d(i1 * n2 + a1, i2 * n2 + a2)
    return key // n2, key % n2


def intersect_ia(i1, a1, i2, a2, n2):
    key = np.intersect1d(i1 * n2 + a1, i2 * n2 + a2)
    return key // n2, key % n2


def _spin_span(spin: np.ndarray, s: int) -> slice:
    """The rows of spin ``s``: one contiguous range in the blocked order."""
    rows = np.flatnonzero(spin == s)
    return slice(int(rows[0]), int(rows[-1]) + 1) if rows.size else slice(0, 0)


def _qk_gather(ctx: STDAContext, occ, vir, spin) -> torch.Tensor:
    """(natm, P) exchange-type charges of a list of CSFs."""
    out = torch.empty((ctx.gk.shape[0], len(occ)), dtype=ctx.gk.dtype, device=ctx.gk.device)
    for s in (0, 1):
        sp = _spin_span(spin, s)
        out[:, sp] = ctx.qk[s][:, occ[sp], vir[sp]]
    return out


def _j_block(ctx: STDAContext, s: int, o_row, v_row, o_col, v_col) -> torch.Tensor:
    """Coulomb-type coupling J[p,q] = sum_AB qj_oo[A,o_p,o_q] gJ qj_vv[B,v_p,v_q]
    of same-spin CSF lists, on K4."""
    return j_block(ctx.g_oo[s], ctx.qj_vv[s], o_row, v_row, o_col, v_col)


def _fock_block(F_occ, F_vir, o_row, v_row, o_col, v_col) -> torch.Tensor:
    """- F_occ[o_p, o_q] delta(v) + delta(o) F_vir[v_p, v_q], on F's device."""
    o_r, v_r, o_c, v_c = (torch.as_tensor(np.asarray(i), device=F_occ.device)
                          for i in (o_row, v_row, o_col, v_col))
    do = (o_r[:, None] == o_c[None, :]).to(F_occ.dtype)
    dv = (v_r[:, None] == v_c[None, :]).to(F_occ.dtype)
    return -F_occ[o_r][:, o_c] * dv + do * F_vir[v_r][:, v_c]


def _velocity_correction(kdiag):
    return 0.5 / units.HA2EV / (1.0 + (kdiag / (0.1 / units.HA2EV)) ** 4)


def csf_diagonal(ctx: STDAContext, sel: CSFSet, correct: bool = False):
    """Host (iaia, iaiak): per-CSF diagonal energies (hartree) and the
    exchange diagonal that the velocity correction reads
    (`os_sTDA.py:33-45, 686-748`); the Coulomb diagonal on K4."""
    occ, vir, spin = sel.gather_arrays(ctx.nc, ctx.no)
    qsel = _qk_gather(ctx, occ, vir, spin)
    kdiag = torch.einsum("Ap,AB,Bp->p", qsel, ctx.gk, qsel).cpu().numpy()
    jdiag = np.empty_like(kdiag)
    fdiag = np.empty_like(kdiag)
    off = 0
    for b in BLOCKS:
        n = sel.count(b)
        s = 0 if b in ("cva", "ova") else 1
        o = occ[off:off + n]
        v = vir[off:off + n]
        jdiag[off:off + n] = j_diagonal(ctx.g_oo[s], ctx.qj_vv[s], o, v).cpu().numpy()
        fo = torch.diagonal(ctx.fock_occ[s]).cpu().numpy()
        fv = torch.diagonal(ctx.fock_vir[s]).cpu().numpy()
        fdiag[off:off + n] = fv[v] - fo[o]
        off += n
    iaia = kdiag - jdiag + fdiag
    if ctx.spinadapt and ctx.no > 0:
        f1, f2, _ = sa_factors(ctx.si)
        dc = np.diag(ctx.dFC)
        dv_ = np.diag(ctx.dFV)
        i_cva, a_cva = sel.idx["cva"]
        i_cvb, a_cvb = sel.idx["cvb"]
        n_cva = sel.count("cva")
        off_cvb = sel.count("cva") + sel.count("ova") + sel.count("cob")
        iaia[:n_cva] += f1 * dv_[a_cva] + f2 * dc[i_cva]
        iaia[off_cvb:] += f2 * dv_[a_cvb] + f1 * dc[i_cvb]
    if correct:
        iaia = iaia + _velocity_correction(kdiag)
    return iaia, kdiag


def _block_span(cset: CSFSet, block: str) -> slice:
    start = 0
    for b in BLOCKS:
        if b == block:
            return slice(start, start + cset.count(b))
        start += cset.count(b)
    raise KeyError(block)


def coupling_matrix(ctx: STDAContext, rows: CSFSet, cols: CSFSet,
                    include_fock: bool = True, include_sa: bool = True,
                    sa_cross_sign: float = -1.0) -> torch.Tensor:
    """Coupling matrix between two CSF sets (blocked CVa|OVa|COb|CVb on both
    axes), on the device: exchange-type K everywhere (a matrix product),
    Coulomb-type J (K4) and the Fock terms between same-spin CSFs, the
    spin-adapted dA on the CV blocks.

    sa_cross_sign: -1 follows X-TDA (`xtddft/XTDA.py:324-331`); +1 gives
    the reference sTDA's literal sign (`os_sTDA.py:106-115`)."""
    occ_r, vir_r, spin_r = rows.gather_arrays(ctx.nc, ctx.no)
    occ_c, vir_c, spin_c = cols.gather_arrays(ctx.nc, ctx.no)
    qr = _qk_gather(ctx, occ_r, vir_r, spin_r)
    qc = _qk_gather(ctx, occ_c, vir_c, spin_c)
    M = qr.T @ ctx.gk @ qc
    for s in (0, 1):
        rr, cc = _spin_span(spin_r, s), _spin_span(spin_c, s)
        if rr.stop == rr.start or cc.stop == cc.start:
            continue
        M[rr, cc] -= _j_block(ctx, s, occ_r[rr], vir_r[rr], occ_c[cc], vir_c[cc])
        if include_fock:
            M[rr, cc] += _fock_block(ctx.fock_occ[s], ctx.fock_vir[s],
                                     occ_r[rr], vir_r[rr], occ_c[cc], vir_c[cc])
    if include_sa and ctx.spinadapt and ctx.no > 0:
        f1, f2, fx = sa_factors(ctx.si)
        fx = abs(fx) * sa_cross_sign
        dFV, dFC = (torch.as_tensor(d, dtype=M.dtype, device=M.device)
                    for d in (ctx.dFV, ctx.dFC))
        for br, bc, c_occ, c_vir in (("cva", "cva", f2, f1), ("cvb", "cvb", f1, f2),
                                     ("cva", "cvb", fx, fx), ("cvb", "cva", fx, fx)):
            i_r, a_r = (torch.as_tensor(x, device=M.device) for x in rows.idx[br])
            i_c, a_c = (torch.as_tensor(x, device=M.device) for x in cols.idx[bc])
            if len(i_r) == 0 or len(i_c) == 0:
                continue
            d_i = (i_r[:, None] == i_c[None, :]).to(M.dtype)
            d_a = (a_r[:, None] == a_c[None, :]).to(M.dtype)
            M[_block_span(rows, br), _block_span(cols, bc)] += (
                c_vir * d_i * dFV[a_r][:, a_c] + c_occ * dFC[i_r][:, i_c] * d_a)
    return M


def perturbative_selection(ctx: STDAContext, pcsf: CSFSet, ncsf: CSFSet,
                           iaia_p: np.ndarray, iaia_n: np.ndarray,
                           tp: float = 1e-4, select_with_fock: bool = True,
                           sa_cross_sign: float = -1.0):
    """Secondary-CSF selection: the perturbative coupling of each N-CSF to
    the P-CSF space, iajb[n] = sum_p A_pn^2 / (E_n - E_p) (`os_sTDA.py:235-261`).

    With select_with_fock=False the estimate keeps the K/J monopole terms
    alone (the reference's literal behavior); the default also includes the
    Fock and dA couplings (its commented-out variant, `os_sTDA.py:795-855`),
    which matters for ROKS references whose spin Fock matrices have large
    off-diagonals.  Returns host (keep, iajb): the keep mask over the
    concatenated N-CSF list and the couplings themselves."""
    if pcsf.dim == 0 or ncsf.dim == 0:
        z = np.zeros(ncsf.dim)
        return z.astype(bool), z
    coup = coupling_matrix(ctx, pcsf, ncsf, include_fock=select_with_fock,
                           include_sa=select_with_fock, sa_cross_sign=sa_cross_sign)
    dev, dt = coup.device, coup.dtype
    denom = (torch.as_tensor(iaia_n, dtype=dt, device=dev)[None, :]
             - torch.as_tensor(iaia_p, dtype=dt, device=dev)[:, None] + 1e-10)
    iajb = torch.sum(coup**2 / denom, dim=0).cpu().numpy()
    return iajb >= tp, iajb


def assemble_A(ctx: STDAContext, sel: CSFSet, correct: bool = False,
               sa_cross_sign: float = -1.0) -> torch.Tensor:
    """The dense truncated A over the selected CSFs (blocked CVa|OVa|COb|CVb),
    on the device."""
    A = coupling_matrix(ctx, sel, sel, sa_cross_sign=sa_cross_sign)
    if correct:
        occ, vir, spin = sel.gather_arrays(ctx.nc, ctx.no)
        qsel = _qk_gather(ctx, occ, vir, spin)
        kd = torch.einsum("Ap,AB,Bp->p", qsel, ctx.gk, qsel)
        A.diagonal().add_(_velocity_correction(kd))
    return A

"""User-facing excited-state method drivers.

Counterpart of the JAX package's `methods/drivers.py`.  Ported so far:

- XTDA    spin-adapted X-TDA on a ROKS/ROHF reference
- SFTDA   spin-flip TDA, extype 'up' (Sf = Si + 1) or 'down' (Sf = Si - 1)
- XSFTDA  spin-adapted spin-flip-down XSF-TDA (arXiv:2511.16906)

each as a density-fitted sigma + block Davidson (backend 'df').
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from xtddft_tpu_torch import units
from xtddft_tpu_torch.props import oscillator, spin
from xtddft_tpu_torch.response.reference_state import Reference, make_reference
from xtddft_tpu_torch.scf.driver import MeanField


@dataclasses.dataclass
class ExcitationResult:
    e: np.ndarray  # hartree
    v: np.ndarray  # (dim, nstates) blocked eigenvectors
    osc: np.ndarray | None = None
    rot: np.ndarray | None = None
    ds2: np.ndarray | None = None
    converged: bool = True
    solver: str | None = None  # which eigensolver path produced e/v
    cycles: int | None = None  # Davidson cycles of the solve

    @property
    def e_eV(self) -> np.ndarray:
        return self.e * units.HA2EV


def _ref_of(mf) -> Reference:
    if isinstance(mf, Reference):
        return mf
    if isinstance(mf, MeanField):
        return make_reference(mf)
    raise TypeError(f"expected MeanField or Reference, got {type(mf)}")


def _resolve_backend(backend: str) -> str:
    """Only the density-fitted backend ('df': DF sigma + device Davidson)
    is ported; 'auto' resolves to it."""
    if backend in ("df", "auto"):
        return "df"
    raise NotImplementedError(
        f"backend {backend!r}: only 'df' is ported; the dense and in-core "
        "backends are in ROADMAP queue 1, item 6")


def _restrict_sigma_op(op, keep: np.ndarray):
    """Matrix-free row/column restriction P^T A P of a sigma operator to the
    ``keep`` index set (frozen core on the DF backend): trial vectors are
    embedded with zeros on the frozen rows, pushed through the full matvec,
    and the kept rows extracted: exactly A[keep][:, keep] at unchanged
    per-matvec cost."""
    import torch

    from xtddft_tpu_torch.response.sigma import SigmaOperator

    keep = np.asarray(keep)
    keep_t = torch.as_tensor(keep, device=op.device)
    dim_full = op.dim

    def matvec(zs):
        zs = torch.as_tensor(zs, dtype=op.dtype, device=op.device)
        zfull = torch.zeros((zs.shape[0], dim_full), dtype=op.dtype, device=op.device)
        zfull[:, keep_t] = zs
        return op.matvec(zfull)[:, keep_t]

    def to_blocked(v):
        v = np.asarray(v)
        vf = np.zeros((dim_full,) + v.shape[1:], dtype=v.dtype)
        vf[keep] = v
        return op.to_blocked(vf)

    return SigmaOperator(matvec=matvec, hdiag=np.asarray(op.hdiag)[keep], dim=keep.size,
                         _to_blocked=to_blocked, device=op.device, dtype=op.dtype)


def _df_solve(build_data, make_op, nroots: int, pick_positive: bool = False):
    """DF eigensolve in the operator's dtype (f64 by default, on CUDA as on
    the CPU): build the DF data on the device, then run the block Davidson
    at the dtype-aware default tolerance.
    Returns (e, v(dim,nroots), conv, op, label, info)."""
    from xtddft_tpu_torch.solver.davidson import davidson

    op = make_op(build_data())
    nroots = min(nroots, op.dim)
    e, vv, conv, info = davidson(
        op.matvec, op.hdiag, nroots=nroots, init_guess=op.init_guess(nroots),
        tol=None, pick_positive=pick_positive, device=op.device, dtype=op.dtype,
    )
    return e, vv, conv, op, "davidson", info


class XTDA:
    """Spin-adapted spin-conserving X-TDA on a restricted-open reference.

    mf: a MeanField or a Reference.  backend: 'df' (density-fitted sigma
    with J/K from the fitted B tensor, MO-grid fxc and dA, solved by the
    device block Davidson)."""

    def __init__(self, mf, nstates: int = 10, backend: str = "df"):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.backend = backend
        if not self.ref.restricted_open:
            raise ValueError("XTDA requires a ROKS/ROHF reference")

    def kernel(self) -> ExcitationResult:
        from xtddft_tpu_torch.response.sigma_df import build_df_data, xtda_sigma_df

        ref = self.ref
        _resolve_backend(self.backend)
        e, vv, conv, op, label, info = _df_solve(
            lambda: build_df_data(ref), xtda_sigma_df, self.nstates,
            pick_positive=True,
        )
        v = op.to_blocked(vv)
        n = min(self.nstates, e.shape[0])
        e, v = e[:n], v[:, :n]
        return ExcitationResult(
            e=e, v=v,
            osc=oscillator.spin_conserving_osc(ref, e, v),
            rot=oscillator.spin_conserving_rot(ref, e, v),
            ds2=spin.xtda_delta_s2(ref, v),
            converged=bool(np.all(conv)), solver=label, cycles=info["cycles"],
        )


class SFTDA:
    """Spin-flip TDA; extype='up' (Sf=Si+1) or 'down' (Sf=Si-1), each through
    the density-fitted exchange + MO-grid SF kernel sigma
    (`sigma_df.sf_sigma_df`) and the device block Davidson.

    method: 0 = ALDA0, 1 = multicollinear, 2 = collinear (HF exchange only)."""

    def __init__(self, mf, nstates: int = 5, extype: str = "down", method: int = 0,
                 backend: str = "df"):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.extype = extype
        self.method = method
        self.backend = backend

    def kernel(self) -> ExcitationResult:
        from xtddft_tpu_torch.response.sigma_df import build_df_data, sf_sigma_df

        ref = self.ref
        _resolve_backend(self.backend)
        # SF spectra are not positive (flip-down roots lie below the
        # high-spin reference): keep every eigenvalue
        e, vv, conv, op, label, info = _df_solve(
            lambda: build_df_data(ref),
            lambda data: sf_sigma_df(data, extype=self.extype, method=self.method),
            self.nstates, pick_positive=False,
        )
        v = op.to_blocked(vv) if self.extype == "down" else vv
        n = min(self.nstates, e.shape[0])
        e, v = e[:n], v[:, :n]
        ds2 = None
        if self.extype == "down" and ref.restricted_open:
            ds2 = spin.xsf_delta_s2_roks(ref, v)
        return ExcitationResult(e=e, v=v, ds2=ds2, converged=bool(np.all(conv)),
                                solver=label, cycles=info["cycles"])


class XSFTDA:
    """Spin-adapted spin-flip-down XSF-TDA (arXiv:2511.16906) through
    `sigma_df.xsf_sigma_df` and the device block Davidson.

    SA: spin-adaptation level 0-3 (default 3 on a restricted-open reference,
    else 0); method: 0 = ALDA0, 1 = multicollinear kernel."""

    def __init__(self, mf, nstates: int = 5, SA: int | None = None, method: int = 0,
                 backend: str = "df", symmetry: bool = False):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.SA = SA if SA is not None else (3 if self.ref.restricted_open else 0)
        self.method = method
        self.backend = backend
        self.symmetry = symmetry

    def kernel(self, nstates: int | None = None, remove: bool | None = None,
               frozen: int | bool | None = None, foo: float = 1.0, d_lda: float = 0.3,
               fglobal: float | None = None, fit: bool = True) -> ExcitationResult:
        """remove: project the Sf=Si contaminant out of the OO block (default:
        on a restricted-open reference).  frozen: drop the innermost
        ``frozen`` core orbitals from the CV and CO excitation blocks
        (True means 1; with remove=False only).  fglobal: the dA scaling,
        default (1 - d_lda) * cx + d_lda, damped by 4 (cx - 1/2)^2 on the
        multicollinear kernel when ``fit``."""
        from xtddft_tpu_torch.response.sigma_df import build_df_data, xsf_sigma_df

        ref = self.ref
        n = nstates if nstates is not None else self.nstates
        if self.symmetry:
            raise NotImplementedError(
                "symmetry=True (state irreps): not ported yet (ROADMAP queue 1, item 6)")
        if self.SA > 0 and ref.no < 2:
            # the spin-adaptation factors contain 1/(2S-1) terms: singular
            # for a doublet reference
            raise ValueError(
                "spin-adapted XSF-TDA requires a reference with S >= 1 "
                "(>= 2 open shells); for a doublet use SA=0 (USF-TDA)")
        if remove is None:
            remove = ref.restricted_open
        if fglobal is None:
            if ref.omega == 0:
                cx = ref.hyb
            else:
                cx = ref.hyb + (ref.alpha - ref.hyb) * math.erf(ref.omega)
            fglobal = (1.0 - d_lda) * cx + d_lda
            if self.method == 1 and fit:
                fglobal = fglobal * 4.0 * (cx - 0.5) ** 2
        _resolve_backend(self.backend)
        dim = (ref.nc + ref.no) * (ref.no + ref.nv)
        keep = None
        if frozen is not None:
            if remove:
                raise ValueError("frozen core is a remove=False feature")
            f = 1 if frozen is True else max(int(frozen), 1)
            nc, no, nv = ref.nc, ref.no, ref.nv
            if f > nc:
                raise ValueError(f"frozen={f} exceeds nc={nc}")
            d1, d2 = nc * nv, nc * nv + nc * no
            keep = np.r_[f * nv: d1, d2 - (nc - f) * no: dim]

        def make_op(data):
            op_ = xsf_sigma_df(data, SA=self.SA, foo=foo, fglobal=fglobal,
                               method=self.method, remove=remove)
            return op_ if keep is None else _restrict_sigma_op(op_, keep)

        e, vv, conv, op, label, info = _df_solve(lambda: build_df_data(ref), make_op, n)
        v_full = op.to_blocked(vv)
        if ref.restricted_open and self.SA != 0:
            ds2 = None  # spin-adapted states: dS2 fixed by construction
        elif ref.restricted_open:
            ds2 = spin.xsf_delta_s2_roks(ref, v_full)
        else:
            ds2 = spin.xsf_delta_s2_uks(ref, v_full)
        return ExcitationResult(e=e, v=v_full, ds2=ds2, converged=bool(np.all(conv)),
                                solver=label, cycles=info["cycles"])

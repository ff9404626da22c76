"""User-facing excited-state method drivers.

Counterpart of the JAX package's `methods/drivers.py`:

- TDA     closed-shell singlet/triplet TDA (dense)
- UTDA    unrestricted TDA, blocked layout (dense)
- XTDA    spin-adapted X-TDA on a ROKS/ROHF reference
- SFTDA   spin-flip TDA, extype 'up' (Sf = Si + 1) or 'down' (Sf = Si - 1)
- XSFTDA  spin-adapted spin-flip-down XSF-TDA (arXiv:2511.16906)
- TDHF    closed-shell full TDHF/RPA, singlet or triplet
- UTDHF   unrestricted full TDHF/RPA, blocked layout
- XTDHF   spin-adapted X-TDHF/RPA on a ROKS/ROHF reference

XTDA, SFTDA and XSFTDA take ``backend``: 'dense' (the full matrix on the
Env's device and ``torch.linalg.eigh`` there, f64), 'incore' (the in-core
sigma operators and the block Davidson at the JAX host solver's tolerance,
1e-7), 'df' (the density-fitted sigma and the block Davidson), or 'auto'
(the default): DF above 120 AOs or a dimension of 4000, dense below, as in
the JAX package.  ``ExcitationResult.solver`` names the route taken.
The TDHF drivers take 'df' (the paired DF sigma and the paired Davidson,
then the stability re-check) or anything else for the dense Casida solve.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from xtddft_tpu_torch import units
from xtddft_tpu_torch.props import oscillator, spin
from xtddft_tpu_torch.response import dense, tdhf
from xtddft_tpu_torch.response.reference_state import Reference, make_reference
from xtddft_tpu_torch.response.spaces import so2st
from xtddft_tpu_torch.scf.driver import MeanField

# the JAX host Davidson's defaults, which its in-core backend runs at
INCORE_TOL = 1e-7
INCORE_MAX_CYCLE = 200
BACKENDS = ("auto", "dense", "incore", "df")


@dataclasses.dataclass
class ExcitationResult:
    e: np.ndarray  # hartree
    v: np.ndarray  # (dim, nstates) blocked eigenvectors
    osc: np.ndarray | None = None
    rot: np.ndarray | None = None
    ds2: np.ndarray | None = None
    converged: bool = True
    irreps: list | None = None  # Mulliken labels (with symmetry=True)
    solver: str | None = None  # which eigensolver path produced e/v
    cycles: int | None = None  # Davidson cycles of the solve
    v_xmy: np.ndarray | None = None  # (X-Y) of full TDHF/RPA (v is X+Y)

    @property
    def e_eV(self) -> np.ndarray:
        return self.e * units.HA2EV


def _ref_of(mf) -> Reference:
    if isinstance(mf, Reference):
        return mf
    if isinstance(mf, MeanField):
        return make_reference(mf)
    raise TypeError(f"expected MeanField or Reference, got {type(mf)}")


def _resolve_backend(ref: Reference, backend: str, dim: int, use_davidson: bool = False) -> str:
    """'dense' (full eigh), 'incore' (matrix-free in-core sigma + Davidson)
    or 'df' (density-fitted sigma + Davidson); 'auto' picks by size as the
    JAX package does (`methods/drivers.py:60`): the explicit
    ``use_davidson`` flag means 'incore', more than 120 AOs or a dimension
    above 4000 means 'df', anything smaller 'dense'."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend != "auto":
        return backend
    if use_davidson:
        return "incore"
    if ref.env.nao > 120 or dim > 4000:
        return "df"
    return "dense"


def _eigh(A: torch.Tensor):
    """Full eigendecomposition on A's device; host numpy (e, v)."""
    e, v = torch.linalg.eigh(A)
    return e.cpu().numpy(), v.cpu().numpy()


def _incore_solve(op, nroots: int, pick_positive: bool = False):
    """The block Davidson on an in-core operator at the JAX host solver's
    tolerance and cycle cap.  Returns (e, v(dim, nroots), conv, info)."""
    from xtddft_tpu_torch.solver.davidson import davidson

    nroots = min(nroots, op.dim)
    e, vv, conv, info = davidson(
        op.matvec, op.hdiag, nroots=nroots, init_guess=op.init_guess(nroots),
        tol=INCORE_TOL, max_cycle=INCORE_MAX_CYCLE, pick_positive=pick_positive,
        device=op.device, dtype=op.dtype)
    return e, vv, conv, info


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


def _df_rpa_solve(op, nroots: int, pick_positive: bool = True):
    """The DF TDHF/RPA solve on the paired operator ``op``
    (`sigma_df.xtda_sigma_df(with_b=True)`): the paired Davidson in the
    operator's dtype at tol 1e-7, then the stability re-check, one
    Rayleigh-Ritz over `_pencil_probe_basis`, which raises
    `RPAInstabilityError` where the projected A - B is not positive definite
    (an externally unstable reference).

    The re-check's Ritz values are not taken (the JAX package's CPU path
    takes them): where A + B has a slightly negative direction, which
    Casida's clamp drops, the probe space mixes it into a spurious low root
    (FH/6-31G ROKS/BHandHLYP on DF: 0.135 eV below the pencil's 2.742 eV;
    `tools/jax_tdhf_fault.py`).  Returns (w, xpy, xmy, conv, label, info)."""
    from xtddft_tpu_torch.solver.rpa import rpa_davidson, rpa_rayleigh_ritz

    nroots = min(nroots, op.dim)
    w, xpy, xmy, conv, info = rpa_davidson(
        op.matvec, op.hdiag, nroots=nroots, init_guess=op.init_guess(nroots), tol=1e-7,
        pick_positive=pick_positive, device=op.device, dtype=op.dtype)
    if xpy.size:
        rpa_rayleigh_ritz(op.matvec, _pencil_probe_basis(xpy, xmy, op.hdiag, nroots), nroots,
                          pos_threshold=1e-6 if pick_positive else 0.0,
                          device=op.device, dtype=op.dtype)
    return w, xpy, xmy, conv, "rpa-davidson+stabcheck", info


def _pencil_probe_basis(xpy, xmy, hdiag, nroots: int) -> np.ndarray:
    """Orthonormal host basis of the stability re-check: span(X+Y, X-Y) and
    the max(2 nroots, 8) lowest-gap Koopmans directions, where instabilities
    live (JAX `methods/drivers.py:291`).  Non-finite columns are zeroed and
    the Koopmans directions lead, so that the re-check raises on an unstable
    reference instead of failing in eigh."""
    dim = xpy.shape[0]
    nseed = min(max(2 * nroots, 8), dim)
    seed = np.zeros((dim, nseed))
    seed[np.argsort(np.asarray(hdiag))[:nseed], np.arange(nseed)] = 1.0
    W = np.concatenate([xpy, xmy], axis=1).astype(np.float64)
    if np.isfinite(W).all():
        Q, R = np.linalg.qr(np.concatenate([W, seed], axis=1))
    else:
        W = np.where(np.isfinite(W), W, 0.0)
        norms = np.linalg.norm(W, axis=0)
        good = norms > 1e-12 * max(1.0, float(norms.max()))
        Q, R = np.linalg.qr(np.concatenate([seed, W[:, good] / norms[good][None, :]], axis=1))
    keep = np.abs(np.diag(R)) > 1e-10
    return Q[:, keep[: Q.shape[1]]]


def _paired_df_op(ref: Reference, spin_adapt: bool):
    from xtddft_tpu_torch.response.sigma_df import build_df_data, xtda_sigma_df

    return xtda_sigma_df(build_df_data(ref), spin_adapt=spin_adapt, with_b=True)


class TDA:
    """Closed-shell TDA on an RKS/RHF reference, dense: the singlet (default)
    or triplet matrix diagonalized on the device."""

    def __init__(self, mf, nstates: int = 5, singlet: bool = True):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.singlet = singlet
        if self.ref.no != 0:
            raise ValueError(
                "TDA requires a closed-shell (RKS/RHF) reference; use UTDA "
                "or XTDA for open-shell systems")

    def kernel(self) -> ExcitationResult:
        ref = self.ref
        A = dense.tda_singlet_dense(ref) if self.singlet else dense.tda_triplet_dense(ref)
        e, v = _eigh(A)
        n = min(self.nstates, e.shape[0])
        e, v = e[:n], v[:, :n]
        if self.singlet:
            osc = oscillator.closed_shell_osc(ref, e, v)
            rot = oscillator.closed_shell_rot(ref, e, v)
        else:
            osc = np.zeros(n)
            rot = np.zeros(n)
        return ExcitationResult(e=e, v=v, osc=osc, rot=rot, solver="dense")


class UTDA:
    """Unrestricted TDA in the blocked CV(a)|OV(a)|CO(b)|CV(b) layout, dense."""

    def __init__(self, mf, nstates: int = 5):
        self.ref = _ref_of(mf)
        self.nstates = nstates

    def kernel(self) -> ExcitationResult:
        ref = self.ref
        e, v = _eigh(dense.utda_dense(ref))
        n = min(self.nstates, e.shape[0])
        e, v = e[:n], v[:, :n]
        return ExcitationResult(
            e=e, v=v,
            osc=oscillator.spin_conserving_osc(ref, e, v),
            rot=oscillator.spin_conserving_rot(ref, e, v),
            ds2=spin.utda_delta_s2(ref, v), solver="dense")


class XTDA:
    """Spin-adapted spin-conserving X-TDA on a restricted-open reference.

    mf: a MeanField or a Reference.  backend: 'auto' | 'dense' | 'incore' |
    'df' (the module docstring); ``use_davidson`` sends 'auto' to
    'incore'; ``so2st_out`` returns the vectors in the spin-tensor basis;
    ``symmetry`` labels each state's irrep."""

    def __init__(self, mf, nstates: int = 10, so2st_out: bool = False,
                 use_davidson: bool = False, backend: str = "auto",
                 symmetry: bool = False):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.so2st_out = so2st_out
        self.use_davidson = use_davidson
        self.backend = backend
        self.symmetry = symmetry
        if not self.ref.restricted_open:
            raise ValueError("XTDA requires a ROKS/ROHF reference")

    def kernel(self) -> ExcitationResult:
        ref = self.ref
        dim = (ref.nc + ref.no) * ref.nv + ref.nc * (ref.no + ref.nv)
        backend = _resolve_backend(ref, self.backend, dim, self.use_davidson)
        cycles = None
        if backend == "df":
            from xtddft_tpu_torch.response.sigma_df import build_df_data, xtda_sigma_df

            e, vv, conv, op, _, info = _df_solve(
                lambda: build_df_data(ref), xtda_sigma_df, self.nstates,
                pick_positive=True)
            v, converged, cycles = op.to_blocked(vv), bool(np.all(conv)), info["cycles"]
        elif backend == "incore":
            from xtddft_tpu_torch.response.sigma import xtda_sigma_operator

            op = xtda_sigma_operator(ref)
            e, vv, conv, info = _incore_solve(op, self.nstates, pick_positive=True)
            v, converged, cycles = op.to_blocked(vv), bool(np.all(conv)), info["cycles"]
        else:
            e, v = _eigh(dense.xtda_dense(ref))
            converged = True
        n = min(self.nstates, e.shape[0])
        e, v = e[:n], v[:, :n]
        irreps = None
        if self.symmetry:
            from xtddft_tpu_torch.props.irreps import state_irreps

            irreps, _ = state_irreps(ref, v, kind="spin_conserving")
        res = ExcitationResult(
            e=e, v=v,
            osc=oscillator.spin_conserving_osc(ref, e, v),
            rot=oscillator.spin_conserving_rot(ref, e, v),
            ds2=spin.xtda_delta_s2(ref, v),
            converged=converged, irreps=irreps, solver=backend, cycles=cycles)
        if self.so2st_out:
            res.v = so2st(v, ref.nc, ref.no, ref.nv)
        return res


class SFTDA:
    """Spin-flip TDA; extype='up' (Sf=Si+1) or 'down' (Sf=Si-1).

    method: 0 = ALDA0, 1 = multicollinear, 2 = collinear (HF exchange only).
    backend: 'auto' | 'dense' | 'incore' | 'df' (the module docstring)."""

    def __init__(self, mf, nstates: int = 5, extype: str = "down", method: int = 0,
                 use_davidson: bool = False, backend: str = "auto"):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.extype = extype
        self.method = method
        self.use_davidson = use_davidson
        self.backend = backend

    def kernel(self) -> ExcitationResult:
        ref = self.ref
        if self.extype not in ("up", "down"):
            raise ValueError(f"extype must be 'up' or 'down', got {self.extype!r}")
        if self.extype == "up":
            dim = ref.nc * ref.nv
        else:
            dim = (ref.nc + ref.no) * (ref.no + ref.nv)
        backend = _resolve_backend(ref, self.backend, dim, self.use_davidson)
        if backend == "df" and self.method == 2 and ref.hyb == 0.0 and ref.omega == 0.0:
            backend = "dense"  # collinear pure functional: A is diagonal
        converged, cycles = True, None
        # SF spectra are not positive (flip-down roots lie below the
        # high-spin reference): keep every eigenvalue
        if backend == "df":
            from xtddft_tpu_torch.response.sigma_df import build_df_data, sf_sigma_df

            e, vv, conv, op, _, info = _df_solve(
                lambda: build_df_data(ref),
                lambda data: sf_sigma_df(data, extype=self.extype, method=self.method),
                self.nstates, pick_positive=False)
            v, converged, cycles = op.to_blocked(vv), bool(np.all(conv)), info["cycles"]
        elif backend == "incore":
            from xtddft_tpu_torch.response.sigma import sf_sigma_operator

            op = sf_sigma_operator(ref, self.extype, self.method)
            e, vv, conv, info = _incore_solve(op, self.nstates)
            v, converged, cycles = op.to_blocked(vv), bool(np.all(conv)), info["cycles"]
        else:
            A = (dense.sf_up_dense(ref, self.method) if self.extype == "up"
                 else dense.sf_down_dense(ref, self.method))
            e, v = _eigh(A)
        n = min(self.nstates, e.shape[0])
        e, v = e[:n], v[:, :n]
        ds2 = None
        if self.extype == "down" and ref.restricted_open:
            ds2 = spin.xsf_delta_s2_roks(ref, v)
        return ExcitationResult(e=e, v=v, ds2=ds2, converged=converged,
                                solver=backend, cycles=cycles)


class XSFTDA:
    """Spin-adapted spin-flip-down XSF-TDA (arXiv:2511.16906).

    SA: spin-adaptation level 0-3 (default 3 on a restricted-open reference,
    else 0); method: 0 = ALDA0, 1 = multicollinear kernel; backend: 'auto' |
    'dense' | 'incore' | 'df' (the module docstring); ``symmetry`` labels
    each state's irrep."""

    def __init__(self, mf, nstates: int = 5, SA: int | None = None, method: int = 0,
                 use_davidson: bool = False, backend: str = "auto", symmetry: bool = False):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.SA = SA if SA is not None else (3 if self.ref.restricted_open else 0)
        self.method = method
        self.use_davidson = use_davidson
        self.backend = backend
        self.symmetry = symmetry

    def kernel(self, nstates: int | None = None, remove: bool | None = None,
               frozen: int | bool | None = None, foo: float = 1.0, d_lda: float = 0.3,
               fglobal: float | None = None, fit: bool = True) -> ExcitationResult:
        """remove: project the Sf=Si contaminant out of the OO block (default:
        on a restricted-open reference).  frozen: drop the innermost
        ``frozen`` core orbitals from the CV and CO excitation blocks
        (True means 1; with remove=False and the dense or DF backend only).
        fglobal: the dA scaling, default (1 - d_lda) * cx + d_lda, damped by
        4 (cx - 1/2)^2 on the multicollinear kernel when ``fit``."""
        ref = self.ref
        n = nstates if nstates is not None else self.nstates
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
        nc, no, nv = ref.nc, ref.no, ref.nv
        dim = (nc + no) * (no + nv)
        backend = _resolve_backend(ref, self.backend, dim, self.use_davidson)
        keep = None
        if frozen is not None:
            if backend not in ("dense", "df"):
                raise ValueError("frozen core requires backend='dense' or 'df'")
            if remove:
                raise ValueError("frozen core is a remove=False feature")
            f = 1 if frozen is True else max(int(frozen), 1)
            if f > nc:
                raise ValueError(f"frozen={f} exceeds nc={nc}")
            d1, d2 = nc * nv, nc * nv + nc * no
            keep = np.r_[f * nv: d1, d2 - (nc - f) * no: dim]
        converged, cycles = True, None
        if backend == "df":
            from xtddft_tpu_torch.response.sigma_df import build_df_data, xsf_sigma_df

            def make_op(data):
                op_ = xsf_sigma_df(data, SA=self.SA, foo=foo, fglobal=fglobal,
                                   method=self.method, remove=remove)
                return op_ if keep is None else _restrict_sigma_op(op_, keep)

            e, vv, conv, op, _, info = _df_solve(lambda: build_df_data(ref), make_op, n)
            v_full, converged, cycles = op.to_blocked(vv), bool(np.all(conv)), info["cycles"]
        elif backend == "incore":
            from xtddft_tpu_torch.response.sigma_xsf import xsf_sigma_operator

            op = xsf_sigma_operator(ref, SA=self.SA, foo=foo, fglobal=fglobal,
                                    method=self.method, remove=remove)
            e, vv, conv, info = _incore_solve(op, n)
            v_full, converged, cycles = op.to_blocked(vv), bool(np.all(conv)), info["cycles"]
        else:
            A, vects = dense.xsf_dense(ref, SA=self.SA, foo=foo, fglobal=fglobal,
                                       method=self.method, remove=remove)
            if keep is not None:
                kt = torch.as_tensor(keep, device=A.device)
                A = A[kt][:, kt]
            e, v = _eigh(A)
            n = min(n, e.shape[0])
            e, v = e[:n], v[:, :n]
            if keep is not None:
                vf = np.zeros((dim, n))
                vf[keep] = v
                v = vf
            if vects is not None:
                d3 = nc * nv + nc * no + no * nv
                v = np.concatenate([v[:d3], vects @ v[d3:]], axis=0)
            v_full = v
        if ref.restricted_open and self.SA != 0:
            ds2 = None  # spin-adapted states: dS2 fixed by construction
        elif ref.restricted_open:
            ds2 = spin.xsf_delta_s2_roks(ref, v_full)
        else:
            ds2 = spin.xsf_delta_s2_uks(ref, v_full)
        irreps = None
        if self.symmetry:
            from xtddft_tpu_torch.props.irreps import state_irreps

            irreps, _ = state_irreps(ref, v_full, kind="spin_flip")
        return ExcitationResult(e=e, v=v_full, ds2=ds2, converged=converged,
                                irreps=irreps, solver=backend, cycles=cycles)


class TDHF:
    """Closed-shell full TDHF/RPA on an RHF/RKS reference, singlet or triplet.

    Result: v = X+Y and v_xmy = X-Y with <X+Y|X-Y> = 1, length-gauge
    oscillator strengths from X+Y and velocity-gauge rotatory strengths from
    X-Y.  backend 'df' solves the spin-resolved DF pencil with 2 nstates + 2
    roots and keeps the roots symmetric (singlet) or antisymmetric (triplet)
    in (za, zb), with the closed-shell amplitude sqrt(2) za; where fewer than
    ``nstates`` of that parity come out, the solve is widened (doubled) until
    they do or the whole space is solved.  Any other backend: dense Casida."""

    def __init__(self, mf, nstates: int = 5, singlet: bool = True, backend: str = "auto"):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.singlet = singlet
        self.backend = backend
        if self.ref.no != 0:
            raise ValueError(
                "TDHF requires a closed-shell (RKS/RHF) reference; use UTDHF "
                "for open-shell systems")

    def kernel(self) -> ExcitationResult:
        ref = self.ref
        backend = _resolve_backend(ref, self.backend, 2 * ref.nc * ref.nv)
        if backend == "df":
            op = _paired_df_op(ref, spin_adapt=False)
            na = ref.nc * ref.nv
            nroots = min(2 * self.nstates + 2, op.dim)
            while True:
                w, xpy, xmy, conv, label, info = _df_rpa_solve(op, nroots)
                za, zb = xpy[:na], xpy[na:]
                num = np.einsum("ds,ds->s", za, zb)
                den = np.linalg.norm(za, axis=0) * np.linalg.norm(zb, axis=0) + 1e-300
                sel = (num / den > 0) if self.singlet else (num / den < 0)
                idx = np.where(sel)[0][: self.nstates]
                if idx.size >= self.nstates or nroots >= op.dim:
                    break
                nroots = min(2 * nroots, op.dim)
            e = w[idx]
            xpy_cs = math.sqrt(2.0) * za[:, idx]
            xmy_cs = math.sqrt(2.0) * xmy[:na, idx]
            converged, cycles = bool(np.all(conv)), info["cycles"]
        else:
            e, xpy_cs, xmy_cs = tdhf.solve_casida(*tdhf.rtdhf_dense(ref, self.singlet),
                                                  self.nstates)
            converged, label, cycles = True, "dense-casida", None
        if self.singlet:
            osc = oscillator.closed_shell_osc(ref, e, xpy_cs)
            rot = oscillator.closed_shell_rot(ref, e, xmy_cs)
        else:
            osc = np.zeros(e.shape[0])
            rot = np.zeros(e.shape[0])
        return ExcitationResult(e=e, v=xpy_cs, osc=osc, rot=rot, v_xmy=xmy_cs,
                                converged=converged, solver=label, cycles=cycles)


class _PairedBase:
    """UTDHF and XTDHF: the blocked pencil, by dense Casida on ``_dense``'s
    (A, B) or by the DF solve, and <dS^2> by ``_ds2``."""

    spin_adapt = False
    _dense = staticmethod(tdhf.utdhf_dense)
    _ds2 = staticmethod(spin.utda_delta_s2)

    def __init__(self, mf, nstates: int = 5, backend: str = "auto"):
        self.ref = _ref_of(mf)
        self.nstates = nstates
        self.backend = backend

    def kernel(self) -> ExcitationResult:
        ref = self.ref
        dim = (ref.nc + ref.no) * ref.nv + ref.nc * (ref.no + ref.nv)
        backend = _resolve_backend(ref, self.backend, dim)
        cycles = None
        if backend == "df":
            op = _paired_df_op(ref, spin_adapt=self.spin_adapt)
            e, xpy_n, xmy_n, conv, label, info = _df_rpa_solve(op, self.nstates)
            xpy, xmy = op.to_blocked(xpy_n), op.to_blocked(xmy_n)
            converged, cycles = bool(np.all(conv)), info["cycles"]
        else:
            e, xpy, xmy = tdhf.solve_casida(*self._dense(ref), self.nstates)
            converged, label = True, "dense-casida"
        return ExcitationResult(
            e=e, v=xpy,
            osc=oscillator.spin_conserving_osc(ref, e, xpy),
            rot=oscillator.spin_conserving_rot(ref, e, xmy),
            ds2=self._ds2(ref, xpy), v_xmy=xmy, converged=converged, solver=label,
            cycles=cycles)


class UTDHF(_PairedBase):
    """Unrestricted full TDHF/RPA in the blocked CV(a)|OV(a)|CO(b)|CV(b)
    layout; backend 'df' is the matrix-free path (the module docstring)."""


class XTDHF(_PairedBase):
    """Spin-adapted X-TDHF/RPA on a restricted-open reference: A is the
    spin-adapted X-TDA matrix, B the bare RPA coupling on the X space
    (`response/tdhf.xtdhf_dense`; B has no dA analog)."""

    spin_adapt = True
    _dense = staticmethod(tdhf.xtdhf_dense)
    _ds2 = staticmethod(spin.xtda_delta_s2)

    def __init__(self, mf, nstates: int = 5, backend: str = "auto"):
        super().__init__(mf, nstates, backend)
        if not self.ref.restricted_open:
            raise ValueError("XTDHF requires a ROKS/ROHF reference")

"""User-facing excited-state method drivers.

Counterpart of the JAX package's `methods/drivers.py`.  Ported so far:

- XTDA    spin-adapted X-TDA on a ROKS/ROHF reference, density-fitted
          sigma + block Davidson (backend 'df')
"""

from __future__ import annotations

import dataclasses

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

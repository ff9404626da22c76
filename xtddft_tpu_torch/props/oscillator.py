"""Oscillator and rotatory strengths (host numpy).

Counterpart of the JAX package's `props/oscillator.py` for the
spin-conserving blocked layout: X normalized X^T X = 1; rotatory strengths
in 1e-40 cgs via `units.CGS2AU`.
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch import units
from xtddft_tpu_torch.response.reference_state import Reference


def _host(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _ov_blocks(ref: Reference, ints: np.ndarray):
    """(3, nao, nao) AO integrals -> alpha (occ x vir) and beta blocks,
    flattened in the CV|OV and CO|CV blocked layout."""
    a = ref.orbo_a.T @ ints @ ref.orbv_a
    b = ref.orbo_b.T @ ints @ ref.orbv_b
    no = ref.no
    b_blocked = np.concatenate(
        [b[:, :, :no].reshape(3, -1), b[:, :, no:].reshape(3, -1)], axis=1
    )
    return a.reshape(3, -1), b_blocked


def _dip_blocks(ref: Reference):
    """MO dipole integrals over (alpha occ x alpha vir) and beta blocks."""
    return _ov_blocks(ref, _host(ref.env.dip))


def _transition(ref: Reference, blocks, v: np.ndarray) -> np.ndarray:
    ba, bb = blocks
    na = ref.nocc_a * ref.nvir_a
    return np.einsum("xi,is->sx", ba, v[:na]) + np.einsum("xi,is->sx", bb, v[na:])


def spin_conserving_osc(ref: Reference, e: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Oscillator strengths for the blocked CV(a)|OV(a)|CO(b)|CV(b) space
    (UTDA/XTDA)."""
    td = _transition(ref, _dip_blocks(ref), v)
    return (2.0 / 3.0) * e * np.einsum("sx,sx->s", td, td)


def spin_conserving_rot(ref: Reference, e: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Velocity-gauge rotatory strengths (1e-40 cgs)."""
    t_e = -_transition(ref, _ov_blocks(ref, _host(ref.env.ipovlp)), v)
    t_m = 0.5 * _transition(ref, _ov_blocks(ref, _host(ref.env.rxp)), v)
    f = np.einsum("s,sx,sx->s", 1.0 / e, t_e, t_m)
    return f / units.CGS2AU

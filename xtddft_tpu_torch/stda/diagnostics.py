"""Truncation-quality diagnostics for sTDA: eigenvector overlaps between
CSF selections and approximation-convergence scans.

Counterpart of the JAX package's `stda/diagnostics.py` (the reference's
`grad_jp/TDA/tools.py`: `overlap`:11 squared normalized overlaps over the
common selected-CSF support, `get_cov`:59, `save_appro_result`:97 CSV dumps
of sTDA energies across approximation settings), host numpy throughout,
against the `STDA` driver's structured selection (`stda/driver.py`): each
run's selected
CSFs are embedded into the PARENT orbital space (the CAS window is a
contiguous slice, `core.ActiveSpace`), so runs with different
`Emax`/`tp`/`cas` settings are directly comparable — the reference's
version requires all runs to share one mask array over a common space.

Typical use::

    drv_ref = STDA(mf, Emax=None, cas=False, nstates=6); r_ref = drv_ref.kernel()
    drv_apx = STDA(mf, Emax=8.0, tp=1e-4, nstates=6);    r_apx = drv_apx.kernel()
    O = subspace_overlap(drv_apx, drv_ref)      # (n_apx, n_ref) squared overlaps
    scan = truncation_scan(mf, [dict(Emax=6), dict(Emax=8), dict(Emax=10)])
    save_scan_csv(scan, "scan.csv")
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch import units
from xtddft_tpu_torch.stda import core
from xtddft_tpu_torch.stda.driver import STDA

__all__ = [
    "embed_to_parent",
    "subspace_overlap",
    "match_states",
    "truncation_scan",
    "save_scan_csv",
]


def _parent_dims(drv: STDA):
    ref = drv.ref
    return ref.nc, ref.no, ref.nv


def _parent_flat_index(drv: STDA) -> np.ndarray:
    """Flat index of every selected CSF of ``drv`` in the parent full CSF
    space (blocked CVa|OVa|COb|CVb over the UNTRUNCATED nc/no/nv), in the
    driver's own row order (block-concatenated)."""
    NC, NO, NV = _parent_dims(drv)
    act = drv.act
    c_off = NC - act.nc  # active core = top slice of the parent core
    offs = {
        "cva": 0,
        "ova": NC * NV,
        "cob": NC * NV + NO * NV,
        "cvb": NC * NV + NO * NV + NC * NO,
    }
    out = []
    for b in core.BLOCKS:
        i, a = drv.sel.idx[b]
        if b == "cva" or b == "cvb":
            out.append(offs[b] + (i + c_off) * NV + a)
        elif b == "ova":
            out.append(offs[b] + i * NV + a)
        else:  # cob
            out.append(offs[b] + (i + c_off) * NO + a)
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def embed_to_parent(drv: STDA, v: np.ndarray | None = None) -> np.ndarray:
    """Scatter eigenvectors ``v`` (rows = selected CSFs in the driver's
    order, defaults to the driver's stored ``drv.v``) into the parent
    full CSF space (zeros outside the selection): (dim_full, nstates)."""
    if v is None:
        v = drv.v
    v = np.asarray(v)
    NC, NO, NV = _parent_dims(drv)
    dim_full = 2 * NC * NV + NO * NV + NC * NO
    out = np.zeros((dim_full, v.shape[1]), dtype=v.dtype)
    out[_parent_flat_index(drv)] = v
    return out


def subspace_overlap(drv: STDA, drv_ref: STDA, v=None, v_ref=None) -> np.ndarray:
    """Squared normalized overlaps between two runs' eigenvectors,
    evaluated over the intersection of their selected-CSF supports
    (the reference's `tools.py:overlap` semantics: dot products restrict
    to common CSFs automatically, norms are the FULL eigenvector norms,
    so a state whose weight lives outside the other run's selection
    scores low).  Returns O[s, t] = |<v[s], v_ref[t]>|^2 with shape
    (nstates, nstates_ref)."""
    V = embed_to_parent(drv, v)
    Vr = embed_to_parent(drv_ref, v_ref)
    n = np.einsum("ps,ps->s", V, V)
    nr = np.einsum("pt,pt->t", Vr, Vr)
    ov = V.T @ Vr
    return ov**2 / np.outer(n, nr)


def match_states(drv: STDA, drv_ref: STDA) -> tuple[np.ndarray, np.ndarray]:
    """(ref_state_of, max_overlap) per approximate state: the reference
    state each approximate eigenvector overlaps most, and that squared
    overlap — the per-state truncation fidelity."""
    O = subspace_overlap(drv, drv_ref)
    return np.argmax(O, axis=1), np.max(O, axis=1)


def truncation_scan(mf, settings, nstates: int = 6, reference=None, **common):
    """Run `STDA` over a list of approximation settings and score each
    against a reference run (default: untruncated `Emax=None, cas=False`).

    ``settings``: iterable of kwarg dicts (e.g. ``{"Emax": 8.0}``,
    ``{"tp": 1e-5}``); ``common``: kwargs applied to every run.

    Returns a dict with per-setting energies (eV), selected dimension,
    max-overlap state mapping and fidelities vs the reference — the
    structured equivalent of the reference's `save_appro_result` CSVs."""
    if reference is None:
        reference = STDA(mf, Emax=None, cas=False, nstates=nstates, **common)
        reference.kernel()
    e_ref = np.asarray(reference.e) * units.HA2EV
    rows = []
    for s in settings:
        drv = STDA(mf, nstates=nstates, **{**common, **s})
        res = drv.kernel()
        mapping, fid = match_states(drv, reference)
        rows.append({
            "setting": dict(s),
            "dim": drv.sel.dim,
            "dim_full": reference.sel.dim,
            "e_ev": (np.asarray(res.e) * units.HA2EV).tolist(),
            "ref_state": mapping.tolist(),
            "overlap": fid.tolist(),
            "de_ev_vs_matched": (
                np.asarray(res.e) * units.HA2EV - e_ref[mapping]
            ).tolist(),
        })
    return {"e_ref_ev": e_ref.tolist(), "rows": rows}


def save_scan_csv(scan: dict, path: str) -> None:
    """Write a `truncation_scan` result as one flat CSV (state-major)."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["setting", "dim", "state", "e_ev", "ref_state",
                    "overlap", "de_ev_vs_matched"])
        for row in scan["rows"]:
            for k, (e, m, o, d) in enumerate(zip(
                    row["e_ev"], row["ref_state"], row["overlap"],
                    row["de_ev_vs_matched"])):
                w.writerow([repr(row["setting"]), row["dim"], k,
                            f"{e:.6f}", m, f"{o:.6f}", f"{d:.6f}"])

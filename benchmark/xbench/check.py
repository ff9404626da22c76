"""What decides ``correct``: the port's answers held to the plain reference.

For each solve sampled from the window, three numbers, each with a limit
of its cell (``limits/<cell>.json``, set from the readings recorded in
PERF.md):

- ``sigma_err``: over every sigma build of the sampled solves, the largest
  ||A_port z - A_ref z|| / ||z|| (Hartree) of a trial vector z, the
  reference applied to the very vectors the window's builds were given.
  Absolute, not relative to ||A_ref z||: a flip operator has roots near
  zero, and a trial vector near such an eigenvector has ||A z|| ~ 1e-3;
- ``root_err``: the largest |e_port - e_ref| (Hartree) over the roots, e_ref
  from the reference's own Davidson solve to ``ref_tol``;
- ``resid``: the largest ||A_ref x - e x|| over the returned roots (e, x),
  x normalised.

A cell compares the numbers that its limits file lists; a number whose
readings do not separate the program from its control is read and printed
but not compared (PERF.md gives its readings).  A solve that did not
converge is failed, and a run with a failed solve is not correct.  The
reference runs in f64 whatever the cell's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import davidson as ref_davidson
from reference import sigma as ref_sigma

NUMBERS = ("sigma_err", "root_err", "resid")


def reference_operator(inp, traffic: dict, dtype=torch.float64, tf32: bool = False):
    kw = {}
    if traffic["method"] == "xsf":
        kw = dict(SA=traffic["SA"], remove=traffic["remove"], fglobal=fglobal(inp.xc, traffic))
    return ref_sigma.Operator(inp, traffic["method"], dtype, tf32=tf32, **kw)


def fglobal(xc_name: str, traffic: dict) -> float:
    """XSF-TDA's dA scale as the drivers set it for a global hybrid with
    the ALDA0 kernel: (1 - d_lda) cx + d_lda, cx the share of exact
    exchange."""
    from reference import xc

    d = traffic["d_lda"]
    return (1.0 - d) * xc.hyb(xc_name) + d


def readings(inp, traffic: dict, samples: list, ref_tol: float) -> dict:
    """The three numbers over ``samples``: dicts with "builds" [(z, az)],
    "e" (nroots,) and "x" (nroots, dim)."""
    op = reference_operator(inp, traffic)
    dev = op.dev
    sigma_err = 0.0
    for s in samples:
        for z, az in s["builds"]:
            ref = op.apply(z.to(dev))
            gap = torch.linalg.norm(az.to(dev, torch.float64) - ref, dim=1)
            norm = torch.linalg.norm(z.to(dev, torch.float64), dim=1)
            sigma_err = max(sigma_err, float((gap / norm).max()))
    nroots = traffic["nroots"]
    e_ref, _, conv = ref_davidson.lowest(op.apply, op.hdiag, nroots, ref_tol, torch.float64, dev,
                                         pick_positive=traffic["pick_positive"])
    if not conv.all():
        raise RuntimeError(f"the reference's own solve did not converge to {ref_tol}")
    root_err = resid = 0.0
    for s in samples:
        e = np.asarray(s["e"], dtype=np.float64)
        root_err = max(root_err, float(np.abs(e - e_ref).max()))
        x = torch.as_tensor(np.asarray(s["x"]), dtype=torch.float64, device=dev)
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        r = op.apply(x) - torch.as_tensor(e, dtype=torch.float64, device=dev)[:, None] * x
        resid = max(resid, float(torch.linalg.norm(r, dim=1).max()))
    return {"sigma_err": sigma_err, "root_err": root_err, "resid": resid}


def traffic_tol(traffic: dict, dtype: torch.dtype) -> float:
    """The traffic's residual tolerance; ``null`` is the Davidson's default
    for the configuration's dtype (1e-6 in f64, 3e-4 in f32), as the
    drivers leave it."""
    if traffic["tol"] is not None:
        return traffic["tol"]
    return 1e-6 if dtype == torch.float64 else 3e-4


def compared(limits: dict) -> list[str]:
    """The numbers a cell compares: those its limits file lists."""
    return [k for k in NUMBERS if k in limits]


def judge(values: dict, limits: dict, failed: int) -> tuple[bool, list[str]]:
    """(correct, lines): the numbers not compared, then each compared number
    beside its limit, and the failed solves."""
    keys = compared(limits)
    lines = [f"{k} {values[k]!r} not compared" for k in NUMBERS if k not in keys]
    lines += [f"{k} {values[k]!r} limit {limits[k]['limit']!r}" for k in keys]
    lines.append(f"failed_solves {failed} limit 0")
    ok = failed == 0 and all(np.isfinite(values[k]) and values[k] <= limits[k]["limit"]
                             for k in keys)
    return ok, lines


def control_sample(inp, traffic: dict, control_dtype: torch.dtype, tf32: bool) -> dict:
    """One solve with the reference in the program's place, in the
    precision below the configuration's (TF32 products for f32, f32 for
    f64): the sample the control's readings are taken from."""
    op = reference_operator(inp, traffic, dtype=control_dtype, tf32=tf32)
    builds = []
    e, x, conv = ref_davidson.lowest(
        op.apply, op.hdiag, traffic["nroots"], traffic_tol(traffic, inp.dtype), control_dtype, op.dev,
        pick_positive=traffic["pick_positive"], extra=0, max_iter=60,
        record=lambda z, az: builds.append((z.clone(), az.clone())))
    return {"builds": builds, "e": e, "x": x.double().cpu().numpy(), "converged": bool(conv.all())}

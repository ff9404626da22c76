"""TTM goldens for X-TDHF and sX-TDA (JAX, CPU, f64).

The JAX package's own runs on the committed ROKS/B3LYP checkpoint of TTM
(tris(2,4,6-trichlorophenyl)methyl, 34 atoms, STO-3G, 182 AO, grid level
1), `load_mf("tests/data/ttm_ckpt.npz", df=True)`:

- X-TDHF, 10 roots: the paired DF operator `xtda_sigma_df(with_b=True,
  spin_adapt=True)` solved by the host SSF paired Davidson
  (`_df_rpa_solve(..., solver="host")`, i.e. `rpa_davidson` at tol 1e-7),
  then the `XTDHF` driver's own post-processing (`to_blocked`,
  `spin_conserving_osc`/`_rot`, `xtda_delta_s2`).  The drivers' default
  solver (`rpa_fulljit`) is not used: on small cases it returns roots that
  are not the operator's (see `tools/jax_tdhf_fault.py`).
- sX-TDA, 10 roots: `STDA(mf, nstates=10).kernel()` with its defaults
  (Emax 10 eV, tp 1e-4, CAS window, union), with the active space and the
  per-block P-CSF and final counts.

Each step's result goes into a work directory (``--work``, default
``build/ttm_tdhf_stda_golden``), and a rerun picks up from there.  The
script writes `tests/data/golden_ttm_xtdhf.json` and
`tests/data/golden_ttm_stda.json` (roots in eV, oscillator and rotatory
strengths, <dS^2>, convergence, the git commit and the seconds taken).
The PyTorch port's `chip_smoke.py` phase 11 gates its own runs of the same
calls against them.

Run:  XTDDFT_PLATFORM=cpu python tools/ttm_tdhf_stda_golden.py [--leg xtdhf|stda]
(about 11 GB; on 8 busy cores the X-TDHF solve took 2.7 hours and the sTDA
leg 2.4 minutes)
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

os.environ.setdefault("XTDDFT_PLATFORM", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DATA = ROOT / "tests" / "data"
CKPT = DATA / "ttm_ckpt.npz"
NROOTS = 10
LEGS = ("xtdhf", "stda")


def _commit() -> str | None:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def _step(work: pathlib.Path, name: str, compute):
    """compute() -> JSON-able dict, or its saved result from ``work``."""
    path = work / f"{name}.json"
    if path.exists():
        return json.loads(path.read_text())
    out = compute()
    path.write_text(json.dumps(out))
    return out


def _xtdhf(mf) -> dict:
    import numpy as np

    from xtddft_tpu import units
    from xtddft_tpu.methods.drivers import _df_rpa_solve
    from xtddft_tpu.props import oscillator, spin
    from xtddft_tpu.response.reference_state import make_reference
    from xtddft_tpu.response.sigma_df import build_df_data

    ref = make_reference(mf)
    s = time.time()
    w, xpy_n, xmy_n, conv, op, label = _df_rpa_solve(
        lambda: build_df_data(ref), NROOTS, spin_adapt=True, solver="host")
    solve_s = time.time() - s
    # the pencil's own residuals, from fresh f64 matvecs of the returned pairs
    out = np.asarray(op.matvec(np.asarray(xpy_n).T))
    ax, bx = out[0].T, out[1].T
    out = np.asarray(op.matvec(np.asarray(xmy_n).T))
    ay, by = out[0].T, out[1].T
    rp = np.linalg.norm(ax + bx - np.asarray(xmy_n) * w[None, :], axis=0)
    rm = np.linalg.norm(ay - by - np.asarray(xpy_n) * w[None, :], axis=0)
    xpy = op.to_blocked(np.asarray(xpy_n))
    xmy = op.to_blocked(np.asarray(xmy_n))
    return {
        "e_ev": (np.asarray(w) * units.HA2EV).tolist(),
        "osc": np.asarray(oscillator.spin_conserving_osc(ref, w, xpy)).tolist(),
        "rot": np.asarray(oscillator.spin_conserving_rot(ref, w, xmy)).tolist(),
        "ds2": np.asarray(spin.xtda_delta_s2(ref, xpy)).tolist(),
        "converged": [bool(c) for c in np.asarray(conv)],
        "residual": np.maximum(rp, rm).tolist(),
        "solver": label, "dim": int(op.dim), "s": solve_s,
    }


def _stda(mf) -> dict:
    import numpy as np

    from xtddft_tpu import units
    from xtddft_tpu.stda import STDA

    s = time.time()
    st = STDA(mf, nstates=NROOTS)
    res = st.kernel()
    act = st.act
    return {
        "e_ev": (np.asarray(res.e) * units.HA2EV).tolist(),
        "osc": np.asarray(res.osc).tolist(), "rot": np.asarray(res.rot).tolist(),
        "ds2": np.asarray(res.ds2).tolist(),
        "active": {"lo": int(act.lo), "hi": int(act.hi), "nc": int(act.nc),
                   "no": int(act.no), "nv": int(act.nv)},
        "pcsf": {k: int(v) for k, v in st.selection["pcsf"].items()},
        "final": {k: int(v) for k, v in st.selection["final"].items()},
        "dim": int(st.selection["dim"]), "dim_full": int(st.selection["dim_full"]),
        "timings": {k: float(v) for k, v in st.timings.items()},
        "s": time.time() - s,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leg", choices=LEGS, action="append")
    ap.add_argument("--work", type=pathlib.Path, default=ROOT / "build" / "ttm_tdhf_stda_golden")
    args = ap.parse_args(argv)
    from xtddft_tpu.scf.checkpoint import load_mf

    args.work.mkdir(parents=True, exist_ok=True)
    s = time.time()
    mf = load_mf(str(CKPT), df=True)
    load_s = time.time() - s
    for leg in args.leg or LEGS:
        out = _step(args.work, leg, lambda: (_xtdhf if leg == "xtdhf" else _stda)(mf))
        print(f"{leg}: eV {out['e_ev']} ({out['s']:.0f} s)", flush=True)
        golden = {
            "molecule": "ttm_vacuum", "basis": "sto-3g", "xc": "b3lyp", "spin": 1,
            "grid_level": 1, "df": True, "nao": int(mf.env.nao), "nstates": NROOTS,
            "mf": "load_mf('tests/data/ttm_ckpt.npz', df=True)",
            "path": ("JAX package, CPU f64: _df_rpa_solve(build_df_data(ref), 10, "
                     "spin_adapt=True, solver='host'), then the XTDHF driver's "
                     "post-processing" if leg == "xtdhf" else
                     "JAX package, CPU f64: STDA(mf, nstates=10).kernel()"),
            "commit": _commit(),
            **{k: v for k, v in out.items() if k != "s"},
            "seconds": {"load_mf": round(load_s, 1), "solve": round(out["s"], 1)},
        }
        path = DATA / f"golden_ttm_{leg}.json"
        path.write_text(json.dumps(golden, indent=1) + "\n")
        print("wrote", path, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

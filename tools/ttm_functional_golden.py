"""TTM goldens for the meta-GGA and range-separated functionals (JAX, CPU, f64).

The JAX package's own DF SCF of TTM (tris(2,4,6-trichlorophenyl)methyl,
34 atoms, STO-3G, 182 AO, grid level 1, density fitted) with two
functionals, each started from the orbitals of the committed ROKS/B3LYP
checkpoint `tests/data/ttm_ckpt.npz`:

- ROKS/TPSSh (meta-GGA, 10% exact exchange), then 10 X-TDA roots and 10
  XSF-TDA roots (SA=0, method=1: the multicollinear kernel);
- ROKS/CAM-B3LYP (range separated, omega = 0.33, its long-range exchange
  from the erf-attenuated fit), then 10 X-TDA roots and 10 XSF-TDA roots
  (SA=0, method=0).

Each response runs through the JAX drivers' DF backend (`backend="df"`).
The multicollinear kernel is pointwise, so the script hands the JAX
package's `sf_kernel_mcol` the grid in blocks of MCOL_POINTS points: at
TTM's 187,644 points in one call its vmapped per-point Hessians take more
than 60 GB.  For the same reason the multicollinear XSF-TDA runs the JAX
drivers' per-cycle Davidson (``solver="device"``) on the JAX operator
applied XSF_VECTORS trial vectors at a time: its fused whole-subspace solve
(``"auto"``) forms (vectors, 3, points, occupied) temporaries and was killed
at 55 GB on a 62 GB host.  That per-cycle solve of TPSSh's multicollinear
XSF-TDA did not converge in 65 minutes on 8 cores, so
`golden_ttm_tpssh.json` was written with ``--no-xsf``: its flip fields are
null and say why.  Each step's result goes into a work directory
(``--work``, default ``build/ttm_functional_golden``: the SCF as a
checkpoint, the solves as JSON), and a rerun picks up from there.
The script writes `tests/data/golden_ttm_tpssh.json` and
`tests/data/golden_ttm_camb3lyp.json`: the SCF's e_tot, cycles and occupied
orbital energies, the roots in eV, the oscillator strengths, <dS^2> of both
solves, the git commit of the tree it ran on and the seconds each step took.
The PyTorch port's `chip_smoke.py` phase 10 gates its own runs of the same
calls against them.

Run:  XTDDFT_PLATFORM=cpu python tools/ttm_functional_golden.py [--xc tpssh|camb3lyp] [--no-xsf]
(both by default; about 13 GB of memory at its peak; on 8 cores the
TPSSh SCF takes ~10 minutes and its X-TDA ~1-1.5 hours)
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
NROOTS = 10
LEGS = {"tpssh": 1, "camb3lyp": 0}  # xc -> the XSF-TDA method
MCOL_POINTS = 2048
XSF_VECTORS = 2


def _commit() -> str | None:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def _blocked_mcol():
    """The JAX package's `sf_kernel_mcol` called on blocks of MCOL_POINTS
    points (it is pointwise) and the blocks concatenated."""
    import jax.numpy as jnp

    from xtddft_tpu.xc import mcol

    real = mcol.sf_kernel_mcol

    def blocked(spec, weights, rho0, nt=20):
        ng = weights.shape[0]
        return jnp.concatenate([real(spec, weights[g:g + MCOL_POINTS],
                                     tuple(r[..., g:g + MCOL_POINTS] for r in rho0), nt)
                                for g in range(0, ng, MCOL_POINTS)], axis=0)

    mcol.sf_kernel_mcol = blocked


def _lean_xsf_operator():
    """The JAX package's `xsf_sigma_df` with its matvec applied to
    XSF_VECTORS trial vectors at a time."""
    import dataclasses

    import jax.numpy as jnp

    from xtddft_tpu.response import sigma_df

    real = sigma_df.xsf_sigma_df

    def lean(*args, **kw):
        op = real(*args, **kw)
        whole = op.matvec

        def matvec(zs):
            return jnp.concatenate([whole(zs[i:i + XSF_VECTORS])
                                    for i in range(0, zs.shape[0], XSF_VECTORS)], axis=0)

        return dataclasses.replace(op, matvec=matvec)

    sigma_df.xsf_sigma_df = lean


def _step(work: pathlib.Path, name: str, compute):
    """compute() -> JSON-able dict, or its saved result from ``work``."""
    path = work / f"{name}.json"
    if path.exists():
        return json.loads(path.read_text())
    out = compute()
    path.write_text(json.dumps(out))
    return out


def run(xc: str, work: pathlib.Path, with_xsf: bool = True) -> dict:
    import numpy as np

    from xtddft_tpu import units
    from xtddft_tpu.chem import Molecule
    from xtddft_tpu.chem import geometries as G
    from xtddft_tpu.methods.drivers import XSFTDA, XTDA
    from xtddft_tpu.scf import ROKS
    from xtddft_tpu.scf.checkpoint import load_mf, save_mf

    method = LEGS[xc]
    work.mkdir(parents=True, exist_ok=True)
    mf_path = work / f"{xc}_mf.npz"
    if mf_path.exists():
        mf = load_mf(str(mf_path), df=True)
        t = json.loads((work / f"{xc}_scf.json").read_text())
    else:
        ckpt = np.load(DATA / "ttm_ckpt.npz")
        mol = Molecule.from_atoms(G.ttm_vacuum, basis="sto-3g", spin=1)
        s = time.time()
        mf = ROKS(mol, xc=xc, grid_level=1, df=True).kernel(init=np.asarray(ckpt["mo_coeff"]))
        t = {"scf_s": time.time() - s}
        if not mf.converged:
            raise RuntimeError(f"{xc}: the SCF did not converge")
        save_mf(mf, str(mf_path))
        (work / f"{xc}_scf.json").write_text(json.dumps(t))
    occ = np.asarray(mf.mo_occ) > 0
    print(f"{xc} SCF: E = {mf.e_tot:.10f} converged={mf.converged} "
          f"({t['scf_s']:.0f} s)", flush=True)

    def solve(make):
        s = time.time()
        res = make().kernel()
        if not res.converged:
            raise RuntimeError(f"{xc}: a response solve did not converge")
        return {"e_ev": (np.asarray(res.e) * units.HA2EV).tolist(),
                "osc": None if res.osc is None else np.asarray(res.osc).tolist(),
                "ds2": np.asarray(res.ds2).tolist(), "s": time.time() - s}

    xsf = {"e_ev": None, "ds2": None, "s": 0.0}
    if with_xsf:
        xsf = _step(work, f"{xc}_xsf", lambda: solve(
            lambda: XSFTDA(mf, nstates=NROOTS, SA=0, method=method, backend="df",
                           solver="device" if method == 1 else "auto")))
        print(f"{xc} XSF-TDA eV: {np.round(xsf['e_ev'], 6)} ({xsf['s']:.0f} s)", flush=True)
    xt = _step(work, f"{xc}_xtda", lambda: solve(
        lambda: XTDA(mf, nstates=NROOTS, backend="df")))
    print(f"{xc} X-TDA eV: {np.round(xt['e_ev'], 6)} ({xt['s']:.0f} s)", flush=True)
    t.update(xtda_s=xt["s"], xsf_s=xsf["s"])
    return {
        "molecule": "ttm_vacuum", "basis": "sto-3g", "xc": xc, "spin": 1,
        "grid_level": 1, "df": True, "nao": int(mf.env.nao),
        "init": "mo_coeff of tests/data/ttm_ckpt.npz (ROKS/B3LYP)",
        "path": "JAX package, CPU f64: ROKS host engine, DF drivers (backend='df')",
        "commit": _commit(),
        "e_scf": float(mf.e_tot), "scf_converged": bool(mf.converged),
        "mo_energy_occ": np.asarray(mf.mo_energy)[occ].tolist(),
        "xtda_e_ev": xt["e_ev"], "xtda_osc": xt["osc"], "xtda_ds2": xt["ds2"],
        "xsf_sa": 0, "xsf_method": method,
        "xsf_solver": (None if not with_xsf else "device: the JAX per-cycle Davidson, the "
                       f"operator applied {XSF_VECTORS} vectors at a time" if method == 1
                       else "auto (fulljit)"),
        "xsf_note": None if with_xsf else (
            "not solved: the JAX multicollinear XSF-TDA at 187,644 points needs more than the "
            "host's 62 GB in its fused solve, and its per-cycle solve did not converge in 65 "
            "minutes"),
        "xsf_e_ev": xsf["e_ev"], "xsf_ds2": xsf["ds2"],
        "seconds": {k: round(v, 1) for k, v in t.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--xc", choices=sorted(LEGS), action="append")
    ap.add_argument("--work", type=pathlib.Path, default=ROOT / "build" / "ttm_functional_golden")
    ap.add_argument("--no-xsf", action="store_true", help="leave the XSF-TDA solve out")
    args = ap.parse_args(argv)
    _blocked_mcol()
    _lean_xsf_operator()
    for xc in args.xc or list(LEGS):
        out = run(xc, args.work, with_xsf=not args.no_xsf)
        path = DATA / f"golden_ttm_{xc}.json"
        path.write_text(json.dumps(out, indent=1) + "\n")
        print("wrote", path, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

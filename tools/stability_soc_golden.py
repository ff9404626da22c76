"""Goldens for SCF internal stability at TTM and the O-atom SOC-SI (JAX, CPU, f64).

Three legs, each the JAX package's own run:

- ``ttm_stability``: the DF internal-stability backend on the committed
  ROKS/B3LYP checkpoint of TTM (34 atoms, STO-3G, 182 AO, grid level 1),
  `load_mf("tests/data/ttm_ckpt.npz", df=True)`.  This is the body of
  `internal_stability(mf, backend="df")` (`scf/stability.py
  _internal_stability_df`): `df_hessian_operator(mf)` and the host block
  Davidson with its arguments (nroots 3, tol 1e-5, max_space_factor 30),
  keeping all three eigenvalues where `internal_stability` returns the
  lowest alone.
- ``o_socsi``: the O atom's 3P term, `ROHF(O, sto-3g, spin=2)` then
  `run_soc_si(mf, nstates=8, cal_osc=True)` as `tests/test_soc_si.py`'s
  fixture runs it: the SCF energy, the SOC levels (hartree and cm^-1 above
  the lowest) and the mean field itself (``o_rohf_ckpt.npz`` beside the
  golden, the JAX `save_mf` format) so that the port can be fed the same
  orbitals;
- ``as_scf``: the As atom's sfX2C-ROKS/BHandHLYP SCF of `tools/run_as_socsi.py`
  (ano-dz, grid level 2), its energy alone, at this commit: the fresh value
  beside `golden_as_socsi.json`'s ``e_scf``, which an older commit stored.

Each leg's result goes into a work directory (``--work``, default
``build/stability_soc_golden``), and a rerun picks up from there.  The
script writes `tests/data/golden_stability_soc.json` (with the git commit
and the seconds each leg took); the PyTorch port's `chip_smoke.py`
phase 12 gates its own runs of the same calls against it.

Run:  XTDDFT_PLATFORM=cpu python tools/stability_soc_golden.py [--leg ttm_stability|o_socsi|as_scf]
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
OUT = DATA / "golden_stability_soc.json"
O_CKPT = DATA / "o_rohf_ckpt.npz"
LEGS = ("ttm_stability", "o_socsi", "as_scf")


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


def _ttm_stability() -> dict:
    import numpy as np

    from xtddft_tpu.scf.checkpoint import load_mf
    from xtddft_tpu.scf.stability import df_hessian_operator
    from xtddft_tpu.solver.davidson import davidson

    s = time.time()
    mf = load_mf(str(CKPT), df=True)
    hvp, hdiag, _ = df_hessian_operator(mf)
    nact = [0]

    def matvec(xs):
        # one vector per call: the same actions as one batched call, at a
        # third of its memory (a batch of three took 35 GB)
        nact[0] += xs.shape[0]
        return np.concatenate([np.asarray(hvp(xs[i:i + 1])) for i in range(xs.shape[0])])

    w, _, conv = davidson(matvec, hdiag, nroots=min(3, hdiag.shape[0]), tol=1e-5,
                          max_space_factor=30)
    return {"w": [float(x) for x in w], "converged": [bool(c) for c in np.asarray(conv)],
            "npairs": int(hdiag.shape[0]), "nao": int(mf.env.nao),
            "hessian_actions": nact[0], "s": time.time() - s}


def _o_socsi() -> dict:
    import numpy as np

    from xtddft_tpu import units
    from xtddft_tpu.chem import Molecule
    from xtddft_tpu.scf import ROHF
    from xtddft_tpu.scf.checkpoint import save_mf
    from xtddft_tpu.soc.pipeline import run_soc_si

    s = time.time()
    mf = ROHF(Molecule.from_atoms("O 0 0 0", basis="sto-3g", spin=2)).kernel()
    save_mf(mf, str(O_CKPT))
    si = run_soc_si(mf, nstates=8, cal_osc=True)
    eso = np.asarray(si.result.eso)
    return {"e_scf": float(mf.e_tot), "eso": eso.tolist(),
            "eso_cm": ((eso - eso[0]) * units.HA2EV * units.EV2CM_1).tolist(),
            "dim": int(si.dim), "s": time.time() - s}


def _as_scf() -> dict:
    from xtddft_tpu.chem import Molecule
    from xtddft_tpu.scf.driver import SCF

    s = time.time()
    mf = SCF(Molecule.from_atoms("As 0 0 0", basis="ano-dz", spin=3), "roks", xc="bhandhlyp",
             grid_level=2, x2c=True).kernel()
    return {"e_scf": float(mf.e_tot), "converged": bool(mf.converged),
            "nao": int(mf.env.nao), "s": time.time() - s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leg", choices=LEGS, action="append")
    ap.add_argument("--work", type=pathlib.Path,
                    default=ROOT / "build" / "stability_soc_golden")
    args = ap.parse_args(argv)
    args.work.mkdir(parents=True, exist_ok=True)
    golden = json.loads(OUT.read_text()) if OUT.exists() else {}
    for leg in args.leg or LEGS:
        out = _step(args.work, leg, {"ttm_stability": _ttm_stability, "o_socsi": _o_socsi,
                                     "as_scf": _as_scf}[leg])
        print(f"{leg}: {json.dumps(out)}", flush=True)
        rec = {k: v for k, v in out.items() if k != "s"}
        rec["seconds"] = round(out["s"], 1)
        rec["commit"] = _commit()
        if leg == "ttm_stability":
            rec["mf"] = "load_mf('tests/data/ttm_ckpt.npz', df=True)"
            rec["path"] = ("JAX package, CPU f64: df_hessian_operator(mf), then "
                           "solver.davidson.davidson(nroots=3, tol=1e-5, "
                           "max_space_factor=30), as internal_stability(backend='df')")
        elif leg == "as_scf":
            rec["mf"] = ("SCF(Molecule.from_atoms('As 0 0 0', basis='ano-dz', spin=3), 'roks', "
                         "xc='bhandhlyp', grid_level=2, x2c=True)")
            rec["path"] = "JAX package, CPU f64: the SCF of tools/run_as_socsi.py"
        else:
            rec["mf"] = "ROHF(Molecule.from_atoms('O 0 0 0', basis='sto-3g', spin=2))"
            rec["path"] = "JAX package, CPU f64: run_soc_si(mf, nstates=8, cal_osc=True)"
            rec["checkpoint"] = O_CKPT.name
        golden[leg] = rec
        OUT.write_text(json.dumps(golden, indent=1) + "\n")
        print("wrote", OUT, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

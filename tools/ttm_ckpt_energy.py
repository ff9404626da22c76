"""Energy of the TTM checkpoint's own density by the JAX host Fock build.

`tests/data/ttm_ckpt.npz` stores a converged ROKS/B3LYP (STO-3G, grid level
1, DF) state and its `e_tot`.  This script rebuilds the checkpoint's Env,
forms the density of its stored orbitals, and evaluates
E = tr(h D) + E2[D] + E_nuc with the JAX package's `SCF._veff_and_exc` as it
stands, one Fock build and no iterations.  E - e_tot tells whether today's
JAX code gives the stored state the stored energy; the PyTorch port's
`chip_smoke.py` phase 7 prints the same difference by its own Fock build
(`e_of_ckpt_density_minus_ckpt_e_tot_ha`).

Run:  XTDDFT_PLATFORM=cpu python tools/ttm_ckpt_energy.py
(host set-up of a few minutes, most of it the Becke grid; ~5 GB of memory)
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    from xtddft_tpu.scf.checkpoint import load_mf
    from xtddft_tpu.scf.driver import SCF

    path = ROOT / "tests" / "data" / "ttm_ckpt.npz"
    t0 = time.perf_counter()
    mf = load_mf(str(path))
    env = mf.env
    scf = SCF(mf.mol, mf.kind, xc=mf.xc.name, env=env)
    d = mf.make_rdm1()
    h = np.asarray(env.hcore)
    _, _, e2 = scf._veff_and_exc(d[0], d[1])
    e = float(np.einsum("pq,qp->", h, d[0] + d[1])) + e2 + mf.mol.energy_nuc()
    rec = {"e_of_ckpt_density": e, "ckpt_e_tot": mf.e_tot,
           "e_of_ckpt_density_minus_ckpt_e_tot_ha": e - mf.e_tot,
           "nao": int(h.shape[0]), "ngrid": int(np.asarray(env.grid_weights).size),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

"""Least times on one NVIDIA H100 of three device functions of the port, from their counts.

Each bound is the larger of the function's operations over the card's peak
rate for f64 and its bytes (each input read once, each output written once)
over the memory rate (`xtddft_tpu_torch/response/flops.py`: 67 TFLOP/s,
3.35 TB/s, the SXM part at 700 W), counted for the inputs the smoke run
gives it:

- ``stability_action``: one DF Hessian action of `scf/stability.py` at TTM
  (182 AO, naux 4412, 187,644 points, grid level 1), 3 vectors, i.e. one
  Fock build of K1 in AO mode, the Coulomb GEMM, K2 hermitian and K3 on the
  AO table on nz = 6 tangent densities (the bounds of the four summed: they
  run one after another);
- ``so2e_as``: the As atom's spin-orbit two-electron term (ano-dz, 159 AO
  uncontracted, the one-centre quartets of `ints/soc_ints.py
  kint_class_blocks`): per primitive quartet the two batched GEMMs
  (3 ncab_bra x nherm_bra) (nherm_bra x nherm_ket) and then (...)
  (nherm_ket x 3 ncab_ket); bytes: the pairs' expansions read once and the
  three SO Fock matrices written once (the quartet blocks in between are
  not an output);
- ``eri_grad_ch2o``: K5 at CH2O+/cc-pVDZ, the count of
  `kernels/eri_grad.GradPlan` (the same as `chip_smoke.py` phase 2 prints).

Host only, no card:  python tools/kernel_bounds.py
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from xtddft_tpu_torch.response import flops as fl  # noqa: E402

TTM = {"nao": 182, "naux": 4412, "npts": 187644, "nz": 6}
F64 = 8


def stability_action() -> dict:
    n, naux, npts, nz = TTM["nao"], TTM["naux"], TTM["npts"], TTM["nz"]
    stages = {
        "k1": (fl.df_exchange_flops(naux, nz, n, n), fl.df_exchange_bytes(naux, nz, n, n, F64)),
        # J = B . t: B read once, t read, J written
        "coulomb": (2.0 * naux * n * n * nz,
                    float(F64) * (naux * n * n + naux * nz + nz * n * n)),
        "k2": (fl.grid_ao_flops(nz, n, npts), fl.grid_ao_bytes(nz, n, npts, F64)),
        "k3": (fl.grid_ao_flops(nz, n, npts), fl.grid_ao_bytes(nz, n, npts, F64)),
    }
    out = {k: {"flops": f, "bytes": b, "bound_ms": fl.bound_ms(f, b, "float64")[0],
               "bound_by": fl.bound_ms(f, b, "float64")[1]} for k, f, b in
           ((k, *v) for k, v in stages.items())}
    out["bound_ms"] = sum(v["bound_ms"] for v in out.values())
    return {"shape": TTM, **out}


def so2e_as() -> dict:
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.ints import build_layout
    from xtddft_tpu_torch.ints.soc_ints import _nherm, _quartets
    from xtddft_tpu_torch.soc.x2c import uncontract

    unc, _ = uncontract(build_layout(Molecule.from_atoms("As 0 0 0", basis="ano-dz", spin=3)))
    shells = unc.shells
    pi, pj, ip, kp = _quartets(unc, True)
    la = np.array([shells[a].l for a in pi])
    lb = np.array([shells[b].l for b in pj])
    nprim = np.array([len(shells[a].exps) * len(shells[b].exps) for a, b in zip(pi, pj)])
    ncab = (la + 1) * (la + 2) // 2 * ((lb + 1) * (lb + 2) // 2)
    nh = np.vectorize(_nherm)(la + lb + 1)
    rb, rk = 3 * ncab[ip], 3 * ncab[kp]
    per_prim = 2.0 * rb * nh[ip] * nh[kp] + 2.0 * rb * nh[kp] * rk
    flops = float(np.sum(per_prim * nprim[ip] * nprim[kp]))
    # the pairs' derivative expansions read once (H and its ket-signed
    # copy), the three SO Fock matrices written once
    nbytes = float(F64) * (2.0 * float(np.sum(nprim * 3 * ncab * nh)) + 3.0 * unc.nao ** 2)
    ms, by = fl.bound_ms(flops, nbytes, "float64")
    return {"nao_uncontracted": unc.nao, "shells": len(shells), "quartets": int(len(ip)),
            "flops": flops, "bytes": nbytes, "bound_ms": ms, "bound_by": by}


def eri_grad_ch2o() -> dict:
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.ints import build_layout
    from xtddft_tpu_torch.kernels.eri_grad import GradPlan

    gold = json.loads((ROOT / "tests/data/golden_ch2o_grad.json").read_text())
    lay = build_layout(Molecule.from_atoms(gold["geometry"], basis="cc-pvdz", charge=1, spin=1))
    p = GradPlan(lay, "cpu")
    ms, by = fl.bound_ms(p.flops, p.nbytes(lay.nao), "float64")
    return {"nao": lay.nao, "flops": p.flops, "bytes": p.nbytes(lay.nao), "bound_ms": ms,
            "bound_by": by}


def main() -> int:
    print(json.dumps({"stability_action": stability_action(), "so2e_as": so2e_as(),
                      "eri_grad_ch2o": eri_grad_ch2o()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

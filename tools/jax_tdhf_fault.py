"""Where the JAX package's DF TDHF/RPA path goes wrong (CPU, f64).

On the FH/6-31G ROKS/BHandHLYP triplet converged through the DF SCF (the
`fh_roks_df` test fixture), with the JAX package alone:

1. the paired DF operator `xtda_sigma_df(with_b=True)` applied to the
   identity gives A and B; their distance from `xtdhf_dense`'s (the fit
   error), and the lowest eigenvalues of A - B and A + B;
2. `solve_casida` on that DF pencil and on the dense one;
3. `_df_rpa_solve(solver="host")` (`rpa_davidson`) and the drivers' default
   `_df_rpa_solve(solver="auto")` (`rpa_fulljit`, then the stability
   re-check's Rayleigh-Ritz over `_pencil_probe_basis`), roots and
   convergence;
4. that Rayleigh-Ritz alone on the host solve's converged pairs: the roots
   the re-check would put in their place.

With ``--all`` it also prints the two `tests/test_tdhf.py` cases seen to
fail on the default path: H2O/STO-3G RKS/B3LYP `TDHF(backend="df")`
singlet and triplet against dense, and OH/6-31G UKS/B3LYP
`UTDHF(backend="df")` against dense.

Run:  XTDDFT_PLATFORM=cpu python tools/jax_tdhf_fault.py [--all]
(about a minute for FH on 8 cores; --all adds a few)
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

os.environ.setdefault("XTDDFT_PLATFORM", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def fh() -> None:
    import numpy as np

    from xtddft_tpu import units
    from xtddft_tpu.chem import Molecule
    from xtddft_tpu.methods.drivers import _df_rpa_solve, _pencil_probe_basis
    from xtddft_tpu.response.reference_state import make_reference
    from xtddft_tpu.response.sigma_df import build_df_data, xtda_sigma_df
    from xtddft_tpu.response.tdhf import solve_casida, xtdhf_dense
    from xtddft_tpu.scf import ROKS
    from xtddft_tpu.solver.rpa import rpa_rayleigh_ritz

    mol = Molecule.from_atoms("F 0 0 0; H 0 0 1.0", basis="6-31g", spin=2)
    mf = ROKS(mol, xc="bhandhlyp", grid_level=1, df=True).kernel()
    ref = make_reference(mf)
    op = xtda_sigma_df(build_df_data(ref), spin_adapt=True, with_b=True)
    ab = np.asarray(op.matvec(np.eye(op.dim)))
    P = op.to_blocked(np.eye(op.dim))  # natural -> blocked rows
    A = P @ ab[0].T @ P.T
    B = P @ ab[1].T @ P.T
    Ad, Bd = (np.asarray(m) for m in xtdhf_dense(ref))
    print(f"FH DF pencil vs xtdhf_dense: max|dA| {np.abs(A - Ad).max():.2e} Ha, "
          f"max|dB| {np.abs(B - Bd).max():.2e} Ha")
    for name, M in (("A-B", A - B), ("A+B", A + B)):
        print(f"lowest eigenvalues of the DF pencil's {name}:",
              np.linalg.eigvalsh(0.5 * (M + M.T))[:3])
    ev = units.HA2EV
    print("solve_casida, DF pencil eV:", solve_casida(A, B, 4)[0] * ev)
    print("solve_casida, dense eV:    ", solve_casida(Ad, Bd, 4)[0] * ev)
    host = None
    for solver in ("host", "auto"):
        w, xpy, xmy, conv, _, label = _df_rpa_solve(
            lambda: build_df_data(ref), 4, spin_adapt=True, solver=solver)
        print(f"_df_rpa_solve(solver={solver!r}) [{label}] eV:", np.asarray(w) * ev,
              f"converged {int(np.sum(conv))}/{len(conv)}")
        if solver == "host":
            host = (xpy, xmy)
    V = _pencil_probe_basis(*host, op.hdiag, 4)
    w = rpa_rayleigh_ritz(op.matvec, V, 4, pos_threshold=1e-6)[0]
    print("the re-check's Rayleigh-Ritz on the host solve's pairs eV:", w * ev)


def others() -> None:
    import numpy as np

    from xtddft_tpu import units
    from xtddft_tpu.chem import Molecule
    from xtddft_tpu.methods.drivers import TDHF, UTDHF
    from xtddft_tpu.scf import RKS, UKS

    mol = Molecule.from_atoms("O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692",
                              basis="sto-3g")
    mf = RKS(mol, xc="b3lyp", grid_level=1).kernel()
    for singlet in (True, False):
        rd = TDHF(mf, nstates=3, singlet=singlet).kernel()
        rf = TDHF(mf, nstates=3, singlet=singlet, backend="df").kernel()
        print(f"H2O TDHF singlet={singlet}: dense Ha {rd.e}, df Ha {rf.e} [{rf.solver}]")
    mol = Molecule.from_atoms("O 0 0 0; H 0 0 0.97", basis="6-31g", spin=1)
    mfu = UKS(mol, xc="b3lyp", grid_level=1).kernel()
    rd = UTDHF(mfu, nstates=4).kernel()
    rf = UTDHF(mfu, nstates=4, backend="df").kernel()
    print(f"OH UTDHF: dense Ha {rd.e}, df Ha {rf.e} [{rf.solver}]; "
          f"max |d| {np.abs(rd.e - rf.e).max() * units.HA2EV:.3e} eV")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true", help="also the H2O and OH cases")
    args = ap.parse_args(argv)
    fh()
    if args.all:
        others()
    return 0


if __name__ == "__main__":
    sys.exit(main())

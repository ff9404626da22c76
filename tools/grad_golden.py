"""Goldens of the JAX package's nuclear gradients for the PyTorch port's CPU tests.

Each case builds the JAX mean field of a small molecule (the molecules of
`tests/test_grad_analytic.py` and `tests/test_grad_tdhf.py`), then stores
what the port's tests hold their own calls against:

- the mean field itself (``mo_coeff``, ``mo_energy``, ``mo_occ``, ``e_tot``,
  ``fock_a``, ``fock_b``), so that the port's gradient runs on the same
  orbitals (two SCFs may land on different states or differ in the last
  converged digits; ROADMAP fault 3.2);
- ``scf_gradient`` (and for HF references `grad.analytic.hf_gradient`);
- for each method the lowest states of `ExcitedGradients.states` (its
  ``jax.hessian`` route), the state gradient taken (the lowest root above
  the zero modes that is not degenerate, ``state``) and its excitation
  energy;
- the integral legs (``ints_h2o``, ``ints_hcl``): the vjps in the
  coordinates of `ints/jaxints.make_integral_fn`'s S, T, V (each alone) and
  ERIs (with ``omega_lr`` for HCl: the erf-attenuated ERIs too), with
  cotangents drawn from ``numpy.random.default_rng(seed)`` in the order S,
  T, V, eri[, eri_lr];
- the sfX2C leg: HCl/STO-3G's differentiable core Hamiltonian
  (`grad/x2c_diff.make_x2c_hcore_fn`) at the reference geometry, its vjp in
  the coordinates with a seeded cotangent, and `sfx2c1e_diff`'s vjp in its
  four matrix inputs with seeded cotangents.

A JAX gradient costs about a minute or two on the CPU (ROADMAP fault 3.7),
so the tests read this file instead of running JAX.  Each case is written to
the output as soon as it is done, and a rerun skips the cases already
there (``--redo`` recomputes them).

Run:  XTDDFT_PLATFORM=cpu python tools/grad_golden.py [--case NAME ...] [--redo] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("XTDDFT_PLATFORM", "cpu")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

OUT = ROOT / "tests" / "data" / "golden_torch_grad.json"
SEED = 20261018

H2O = "O 0 0 0; H 0 0 0.96; H 0.93 0 -0.25"
OH = "O 0 0 0; H 0 0 0.98"
H2 = "H 0 0 0; H 0 0 0.8"
HCL = "Cl 0 0 0; H 0 0 1.29"

# name: (atoms, spin, kind, xc, grid level, x2c, [(method, sf_method)], hf_gradient)
CASES = {
    "h2o_rhf": (H2O, 0, "rhf", None, 1, False,
                [("cis", 0), ("cis-triplet", 0), ("rtdhf", 0), ("rtdhf-triplet", 0)], True),
    "oh_rohf": (OH, 1, "rohf", None, 1, False, [("xcis", 0), ("sfcis-up", 0), ("xtdhf", 0)],
                True),
    "oh_uhf": (OH, 1, "uhf", None, 1, False, [("ucis", 0), ("utdhf", 0)], True),
    "h2_rks_svwn": (H2, 0, "rks", "svwn", 1, False, [("cis", 0)], False),
    "oh_roks_bhandhlyp": (OH, 1, "roks", "bhandhlyp", 0, False,
                          [("sfcis-up", 0), ("sfcis-up", 1)], False),
    "hcl_rhf_x2c": (HCL, 0, "rhf", None, 1, True, [], False),
}
# integral legs: name -> (atoms, omega_lr)
INT_CASES = {"ints_h2o": (H2O, 0.0), "ints_hcl": (HCL, 0.33)}


def int_case(name: str) -> dict:
    import jax
    import jax.numpy as jnp

    from xtddft_tpu.chem import Molecule
    from xtddft_tpu.ints import build_layout
    from xtddft_tpu.ints.jaxints import make_integral_fn

    atoms, omega = INT_CASES[name]
    t0 = time.time()
    mol = Molecule.from_atoms(atoms, basis="sto-3g")
    layout = build_layout(mol)
    coords = jnp.asarray(np.asarray(mol.coords, dtype=np.float64))
    rng = np.random.default_rng(SEED)
    n = layout.nao
    keys = ["S", "T", "V", "eri"] + (["eri_lr"] if omega > 0 else [])
    cts = {k: rng.standard_normal((n, n) if len(k) == 1 else (n,) * 4) for k in keys}
    rec = {"atoms": atoms, "basis": "sto-3g", "omega_lr": omega, "vjp": {}}
    one = make_integral_fn(layout, do_eri=False)
    for k in "STV":
        _, vjp = jax.vjp(lambda c, k=k: one(c)[k], coords)
        rec["vjp"][k] = np.asarray(vjp(jnp.asarray(cts[k]))[0]).tolist()
    full = make_integral_fn(layout, omega_lr=omega)
    for k in keys[3:]:
        _, vjp = jax.vjp(lambda c, k=k: full(c)[k], coords)
        rec["vjp"][k] = np.asarray(vjp(jnp.asarray(cts[k]))[0]).tolist()
    rec["seconds"] = time.time() - t0
    return rec


def _lowest_simple_root(e, gap: float = 1e-5) -> int:
    """The lowest root above the zero modes (an open-shell reference's spin
    rotation) that is not degenerate with a neighbour."""
    e = np.asarray(e)
    for k in range(len(e)):
        if e[k] < 1e-6:
            continue
        lo = k == 0 or e[k] - e[k - 1] > gap
        hi = k == len(e) - 1 or e[k + 1] - e[k] > gap
        if lo and hi:
            return k
    raise ValueError(f"no simple root among {e}")


def _x2c_leg(mf, layout) -> dict:
    import jax
    import jax.numpy as jnp

    from xtddft_tpu import units
    from xtddft_tpu.grad.x2c_diff import make_x2c_hcore_fn, sfx2c1e_diff
    from xtddft_tpu.ints import jaxints as J
    from xtddft_tpu.soc.x2c import uncontract

    rng = np.random.default_rng(SEED)
    coords = jnp.asarray(np.asarray(mf.mol.coords, dtype=np.float64))
    fn = make_x2c_hcore_fn(layout, units.C_AU)
    h, vjp = jax.vjp(fn, coords)
    ct = rng.standard_normal(h.shape)
    (gc,) = vjp(jnp.asarray(ct))
    unc, _ = uncontract(layout)
    charges = np.asarray(unc.mol.charges, dtype=np.float64)
    n = unc.nao
    mats = {k: jnp.zeros((n, n)) for k in "SVTW"}
    for pc in J._pair_classes(unc):
        s_blk, t_blk = J._overlap_kinetic(pc, coords)
        mats["S"] = J._scatter2(mats["S"], pc, s_blk)
        mats["T"] = J._scatter2(mats["T"], pc, t_blk)
        mats["V"] = J._scatter2(mats["V"], pc, J._nuclear(pc, coords, charges))
        mats["W"] = J._scatter2(mats["W"], pc, J._pvp(pc, coords, charges))
    h1, vjp1 = jax.vjp(lambda t, v, w, s: sfx2c1e_diff(t, v, w, s, units.C_AU),
                       mats["T"], mats["V"], mats["W"], mats["S"])
    ct1 = rng.standard_normal(h1.shape)
    gt, gv, gw, gs = vjp1(jnp.asarray(ct1))
    return {"hcore": np.asarray(h).tolist(), "hcore_cotangent": ct.tolist(),
            "hcore_vjp": np.asarray(gc).tolist(), "sfx2c1e_cotangent": ct1.tolist(),
            "sfx2c1e": np.asarray(h1).tolist(),
            "sfx2c1e_vjp": {k: np.asarray(v).tolist()
                            for k, v in zip("tvws", (gt, gv, gw, gs))}}


def run_case(name: str) -> dict:
    from xtddft_tpu.chem import Molecule
    from xtddft_tpu.grad.analytic import hf_gradient
    from xtddft_tpu.grad.lagrangian import ExcitedGradients, scf_gradient
    from xtddft_tpu.scf.driver import SCF

    atoms, spin, kind, xc, level, x2c, methods, with_hf = CASES[name]
    t0 = time.time()
    mol = Molecule.from_atoms(atoms, basis="sto-3g", spin=spin)
    mf = SCF(mol, kind, xc=xc, grid_level=level, x2c=x2c).kernel()
    assert mf.converged, name
    rec = {"atoms": atoms, "spin": spin, "kind": kind, "xc": xc, "grid_level": level,
           "x2c": x2c, "basis": "sto-3g",
           "mf": {k: np.asarray(getattr(mf, k)).tolist()
                  for k in ("mo_coeff", "mo_energy", "mo_occ", "fock_a", "fock_b")},
           "e_tot": float(mf.e_tot)}
    rec["scf_gradient"] = np.asarray(scf_gradient(mf)).tolist()
    if with_hf:
        rec["hf_gradient"] = np.asarray(hf_gradient(mf)).tolist()
    if x2c:
        rec["x2c"] = _x2c_leg(mf, mf.env.layout)
    rec["methods"] = {}
    for method, sf_method in methods:
        eg = ExcitedGradients(mf, method=method, sf_method=sf_method)
        e, _ = eg.states(4)
        state = _lowest_simple_root(e)
        g, w = eg.kernel(state=state, nstates=4)
        rec["methods"][f"{method}/{sf_method}"] = {
            "states_e": np.asarray(e).tolist(), "state": state, "omega": float(w),
            "grad": np.asarray(g).tolist()}
        print(f"  {name} {method}/{sf_method}: state {state}, omega {w:.10f}", flush=True)
    rec["seconds"] = time.time() - t0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", nargs="*", choices=sorted(CASES) + sorted(INT_CASES),
                    help="cases to run (all)")
    ap.add_argument("--redo", action="store_true", help="recompute cases already stored")
    ap.add_argument("--out", type=pathlib.Path, default=OUT, help=f"output (default {OUT})")
    args = ap.parse_args(argv)
    out = args.out
    data = json.loads(out.read_text()) if out.exists() else {}
    data["seed"] = SEED
    data["commit"] = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                                    text=True).stdout.strip()
    data.setdefault("cases", {})
    for name in args.case or list(CASES) + list(INT_CASES):
        if name in data["cases"] and not args.redo:
            continue
        print(f"case {name}", flush=True)
        data["cases"][name] = (int_case if name in INT_CASES else run_case)(name)
        out.write_text(json.dumps(data, indent=1))
        print(f"case {name}: {data['cases'][name]['seconds']:.0f} s", flush=True)
    out.write_text(json.dumps(data, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The TTM/dzp checkpoint under the JAX package's host f64 engine.

`tests/data/ttm_dzp_ckpt.npz` stores a ROKS/B3LYP state (dzp, 598 AO, grid
level 1, density fitted with the "jk" aux basis) that the JAX package's
mixed-precision device engine converged, and its `e_tot`.  This script
rebuilds the checkpoint's Env on the host, forms the density of its stored
orbitals, and evaluates E = tr(h D) + E2[D] + E_nuc with the pieces of the
JAX package's `SCF._veff_and_exc` as they stand (`_df_j` and `_df_k` on the
host-dressed fitted tensor, `cache_rho` and `vxc_matrices` on the grid), one
Fock build and no iterations, and the orbital gradient |g| of the Roothaan
Fock there (the SCF's convergence measure).  It is `tools/ttm_ckpt_energy.py`
for the dzp checkpoint, with one change for the host's memory: J and K are
sums over the aux index, so the fitted tensor goes through `_df_j` and
`_df_k` 256 aux rows at a time, and the raw j3c is dropped once dressed.
The PyTorch port's `chip_smoke.py` phase 8 prints the same difference and
gradient by its own Fock build.

``--compare-fit`` also evaluates the energy with the PyTorch port's fit
inputs in place of the JAX package's (everything else stays the JAX
package's): first its 2-center metric alone, then its 3-center integrals and
metric both, then those dressed with the aux sum of metric^-1/2 @ j3c split
in two halves (the same fit rounded in another order).  At TTM/dzp the kept
metric spans a condition number of ~2e14, so the few-ulp differences
between the two builds of the integral engine, and the summation order of
the dressing, move the fitted energy; the energies show how much of the two
packages' difference each carries.

``--solve`` solves the JAX package's f64 X-TDA (20 roots) and XSF-TDA (SA=0,
10 roots, the flip golden's arguments) on the checkpoint with the eigensolve
of the JAX drivers' DF backend (`methods/drivers.py _df_solve`: on the CPU
the jitted Davidson at its f64 tolerance), from the operators' own diagonal
guesses: an eigensolve of the reference package at full size
that never sees the port.  From the same dressed tensor the script builds
everything those operators read, in f64 (the HF Fock pair of
`make_reference`'s host recipe, h + J - K_sigma; B in the MO basis, 64 aux
rows at a time; the MO grid table and the ground-state density).  It prints
the roots in eV, the flip roots' <dS^2>, and their distance from the
goldens' `e_refined_ev`.

``--rayleigh VECTORS`` applies the same two operators to the port's
eigenvectors.  `chip_smoke.py --out PATH` writes the X-TDA and XSF-TDA
eigenpairs of its phase 8 to ``<PATH stem>_dzp_vectors.npz``.  Per root the
script prints the Rayleigh quotient v.Av / v.v in eV beside the port's root,
the residual |Av - ev| / |v|, and the JAX <dS^2> of the flip vectors.

Run:  XTDDFT_PLATFORM=cpu python tools/ttm_dzp_ckpt_energy.py [--compare-fit]
          [--solve] [--rayleigh VECTORS]
(about 25 GB of memory at its peak, 30 with ``--solve`` or ``--rayleigh``;
on 8 cores about 10 minutes, 15 with ``--rayleigh``, 20 with
``--compare-fit``, 100 with ``--solve``)
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CKPT = ROOT / "tests/data/ttm_dzp_ckpt.npz"
AUX_ROWS = 256
NROOTS_XTDA, NROOTS_XSF = 20, 10


def _fock_energy(scf, mf, B) -> dict:
    """E = tr(h D) + E2[D] + E_nuc of the checkpoint's density and its
    orbital gradient |g|, with J and K from the dressed tensor ``B`` (host
    f64, AUX_ROWS rows at a time), and the HF Fock pair h + J - K_sigma."""
    import jax.numpy as jnp

    from xtddft_tpu.scf.driver import _sym_orth
    from xtddft_tpu.scf.env import _df_j, _df_k
    from xtddft_tpu.xc import interface as xci

    env, spec = mf.env, mf.xc
    da, db = mf.make_rdm1()
    dtot = da + db
    J = Ka = Kb = 0.0
    for p0 in range(0, B.shape[0], AUX_ROWS):
        Bc = jnp.asarray(B[p0:p0 + AUX_ROWS])
        J = J + np.asarray(_df_j(Bc, jnp.asarray(dtot)))
        Ka = Ka + np.asarray(_df_k(Bc, jnp.asarray(da)))
        Kb = Kb + np.asarray(_df_k(Bc, jnp.asarray(db)))
    rho = scf._rho_pair(da, db)
    exc, va, vb = xci.vxc_matrices(spec, env.ao, env.grid_weights, rho)
    ka, kb = spec.hyb * Ka, spec.hyb * Kb
    veff_a = J + np.asarray(va) - ka
    veff_b = J + np.asarray(vb) - kb
    e2 = (0.5 * np.einsum("pq,qp->", dtot, J)
          - 0.5 * (np.einsum("pq,qp->", da, ka) + np.einsum("pq,qp->", db, kb)) + float(exc))
    h = np.asarray(env.hcore)
    e = float(np.einsum("pq,qp->", h, dtot)) + e2 + mf.mol.energy_nuc()
    S = np.asarray(env.S)
    f = scf._roothaan_fock(h + veff_a, h + veff_b, db, da - db, S)
    X = _sym_orth(S)
    g = float(np.linalg.norm(X.T @ (f @ dtot @ S - S @ dtot @ f) @ X))
    return {"e": e, "g": g, "fock_hf_ao": (h + J - Ka, h + J - Kb)}


def _dressed(env) -> np.ndarray:
    """The Env's host-dressed tensor; the raw j3c is not kept."""
    B = env.df_B_host()
    env._df_j3c_cache.clear()
    env._df_B_host_cache.clear()
    return B


def _split_dressing(isqrt, j3c) -> np.ndarray:
    """isqrt @ j3c with the aux sum in two halves added: the same fitted
    tensor in another summation order."""
    nx = j3c.shape[0]
    J = j3c.reshape(nx, -1)
    h = nx // 2
    lo, hi = np.ascontiguousarray(isqrt[:, :h]), np.ascontiguousarray(isqrt[:, h:])
    B = np.empty_like(J)
    for c0 in range(0, J.shape[1], 1 << 16):
        c = slice(c0, c0 + (1 << 16))
        B[:, c] = lo @ J[:h, c]
        B[:, c] += hi @ J[h:, c]
    return B.reshape(j3c.shape)


def _compare_fit(scf, mf) -> dict:
    """The energy of the checkpoint's density with the port's metric, then
    with the port's j3c and metric, then the same once more with the
    dressing's aux sum split in two halves, in the JAX package's Fock
    build."""
    from xtddft_tpu.ints.two_electron import eri_2c as jax_eri_2c
    from xtddft_tpu_torch.ints.two_electron import eri_2c
    from xtddft_tpu_torch.scf.checkpoint import load_mf as port_load_mf

    env = mf.env
    penv = port_load_mf(str(CKPT), df=True, device="cpu").env
    M, Mj = eri_2c(penv.aux_layout), jax_eri_2c(env.aux_layout)
    wj = np.linalg.eigvalsh(Mj)
    w, U = penv.df_metric_eig_host()
    out = {"max_abs_metric_diff": float(np.abs(M - Mj).max()),
           "max_abs_metric": float(np.abs(Mj).max()),
           "smallest_kept_eigenvalues": {"port": w[:4].tolist(), "jax": wj[wj > 1e-10][:4].tolist()}}
    del M, Mj
    env._df_meig_cache = {0.0: (w, U)}
    env._df_isqrt_cache = {}  # the JAX metric's, from the first dressing
    s = time.perf_counter()
    out["port_metric"] = _fock_energy(scf, mf, _dressed(env))
    out["port_metric"]["seconds"] = time.perf_counter() - s
    s = time.perf_counter()
    j3c = penv.df_j3c_host()
    penv._df_j3c_cache.clear()
    env.set_df_j3c(j3c)
    out["port_j3c_and_metric"] = _fock_energy(scf, mf, _dressed(env))
    out["port_j3c_and_metric"]["seconds"] = time.perf_counter() - s
    s = time.perf_counter()
    out["port_fit_split_dressing"] = _fock_energy(scf, mf, _split_dressing(env.df_isqrt_host(), j3c))
    out["port_fit_split_dressing"]["seconds"] = time.perf_counter() - s
    del j3c
    for k in ("port_metric", "port_j3c_and_metric", "port_fit_split_dressing"):
        del out[k]["fock_hf_ao"]
        out[k]["e_minus_ckpt_e_tot_ha"] = out[k]["e"] - mf.e_tot
    return out


def _operators(mf, held, fock_hf_ao):
    """The reference and the f64 DF data of the JAX X-TDA and XSF-TDA
    operators; ``held`` holds the host-dressed AO tensor, which is dropped
    once in the MO basis; ``fock_hf_ao`` the HF Fock pair on the
    checkpoint's density."""
    import jax.numpy as jnp

    from xtddft_tpu.response.reference_state import make_reference
    from xtddft_tpu.response.sigma import _rho0_jnp
    from xtddft_tpu.response.sigma_df import DFData

    env = mf.env
    mo = make_reference(mf, fock_hf_mo=(None, None)).mo_a  # the c|o|v order
    ref = make_reference(mf, fock_hf_mo=tuple(mo.T @ f @ mo for f in fock_hf_ao))
    nmo = mo.shape[1]
    B = held.pop()
    Bmo = np.empty((B.shape[0], nmo, nmo))
    for p0 in range(0, B.shape[0], 64):
        Bmo[p0:p0 + 64] = mo.T @ B[p0:p0 + 64] @ mo
    del B
    Bj = jnp.asarray(Bmo)
    del Bmo
    data = DFData(
        nc=ref.nc, no=ref.no, nv=ref.nv, B=Bj, fock_mo=np.stack([ref.fock_a_mo, ref.fock_b_mo]),
        hyb=ref.hyb, spec=ref.spec, phi=jnp.einsum("xgm,mp->xgp", env.ao, jnp.asarray(mo)),
        grid_w=env.grid_weights, rho0=_rho0_jnp(ref),
        fock_hf_mo=np.stack([ref.fock_a_hf_mo, ref.fock_b_hf_mo]))
    return ref, data


def _xsf_op(data):
    from xtddft_tpu.response.sigma_df import xsf_sigma_df

    g = GOLDEN_XSF
    return xsf_sigma_df(data, SA=int(g["SA"]), foo=1.0, fglobal=float(g["fglobal"]), method=0,
                        remove=True)


def _solve(ref, data) -> dict:
    """The JAX package's DF eigensolve (`methods.drivers._df_solve`, the one
    its `XTDA` and `XSFTDA` call with ``backend="df"``) on the f64 operators,
    from their own diagonal guesses."""
    from xtddft_tpu import units
    from xtddft_tpu.methods.drivers import _df_solve
    from xtddft_tpu.props import spin
    from xtddft_tpu.response.sigma_df import xtda_sigma_df

    out = {}
    for name, make_op, n, pos, golden in (
            ("xtda", xtda_sigma_df, NROOTS_XTDA, True, GOLDEN_XTDA),
            ("xsf", _xsf_op, NROOTS_XSF, False, GOLDEN_XSF)):
        s = time.perf_counter()
        e, vv, conv, op, label = _df_solve(lambda: data, make_op, n, pick_positive=pos)
        e_ev = np.asarray(e) * units.HA2EV
        dev = e_ev - np.asarray(golden["e_refined_ev"])[:n]
        out[name] = {"e_ev": e_ev.tolist(), "nconv": int(np.sum(conv)), "nroots": n,
                     "solver": label, "golden_minus_jax_ev": (-dev).tolist(),
                     "max_abs_dev_from_golden_ev": float(np.abs(dev).max()),
                     "seconds": time.perf_counter() - s}
        if name == "xsf":
            ds2 = np.asarray(spin.xsf_delta_s2_roks(ref, op.to_blocked(vv)))
            out[name].update(ds2=ds2.tolist(),
                             max_abs_ds2_dev_from_golden=float(
                                 np.abs(ds2 - np.asarray(golden["ds2"])[:n]).max()))
    return out


def _rayleigh(op, V):
    """(v.Av / v.v, |Av - (v.Av / v.v) v| / |v|) per column of V (natural layout)."""
    import jax.numpy as jnp

    AV = np.asarray(op.matvec(jnp.asarray(V.T))).T
    vv = np.einsum("in,in->n", V, V)
    R = np.einsum("in,in->n", V, AV) / vv
    return R, np.linalg.norm(AV - R[None, :] * V, axis=0) / np.sqrt(vv)


def _certify(ref, data, vectors) -> dict:
    """The JAX f64 X-TDA and XSF-TDA operators applied to the port's
    eigenvectors in ``vectors``."""
    from xtddft_tpu import units
    from xtddft_tpu.props import spin
    from xtddft_tpu.response.sigma_df import xtda_sigma_df
    from xtddft_tpu.response.spaces import sf_oo_projector

    z = np.load(vectors)

    def leg(op, V, e):
        R, res = _rayleigh(op, V)
        return {"port_ev": (e * units.HA2EV).tolist(), "jax_rayleigh_ev": (R * units.HA2EV).tolist(),
                "max_abs_diff_ev": float(np.abs(R - e).max() * units.HA2EV),
                "max_residual": float(res.max())}

    op = xtda_sigma_df(data)
    perm = op.to_blocked(np.arange(op.dim, dtype=np.float64)[:, None])[:, 0].astype(np.int64)
    V = np.empty_like(z["xtda_v"])
    V[perm] = z["xtda_v"]  # the blocked layout back to the natural one
    out = {"xtda": leg(op, V, z["xtda_e"])}
    op = _xsf_op(data)
    vf = z["xsf_v"]
    d3 = op.dim - (ref.no * ref.no - 1)
    # the OO block's projection back to the operator's basis
    V = np.concatenate([vf[:d3], np.asarray(sf_oo_projector(ref.no)).T @ vf[d3:]], axis=0)
    out["xsf"] = leg(op, V, z["xsf_e"])
    ds2 = np.asarray(spin.xsf_delta_s2_roks(ref, vf))
    out["xsf"].update(port_ds2=z["xsf_ds2"].tolist(), jax_ds2=ds2.tolist(),
                      max_abs_ds2_diff=float(np.abs(ds2 - z["xsf_ds2"]).max()))
    return out


GOLDEN_XTDA = json.loads((ROOT / "tests/data/golden_ttm_dzp.json").read_text())
GOLDEN_XSF = json.loads((ROOT / "tests/data/golden_ttm_dzp_xsf.json").read_text())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare-fit", action="store_true")
    ap.add_argument("--solve", action="store_true")
    ap.add_argument("--rayleigh", type=pathlib.Path, metavar="VECTORS")
    args = ap.parse_args()
    if args.compare_fit and (args.solve or args.rayleigh is not None):
        ap.error("--compare-fit runs alone (the host's memory holds one fitted tensor)")

    from xtddft_tpu.scf.checkpoint import load_mf
    from xtddft_tpu.scf.driver import SCF

    t0 = time.perf_counter()
    seconds = {}
    mf = load_mf(str(CKPT))
    env = mf.env
    scf = SCF(mf.mol, mf.kind, xc=mf.xc.name, env=env)
    w = env.df_metric_eig_host()[0]
    s = time.perf_counter()
    B = _dressed(env)
    seconds["j3c_and_dressing"] = time.perf_counter() - s
    s = time.perf_counter()
    fe = _fock_energy(scf, mf, B)
    seconds["energy"] = time.perf_counter() - s
    rec = {"e_of_ckpt_density": fe["e"], "ckpt_e_tot": mf.e_tot,
           "e_of_ckpt_density_minus_ckpt_e_tot_ha": fe["e"] - mf.e_tot,
           "gnorm_of_ckpt_density": fe["g"], "nao": int(env.nao),
           "naux": int(env.aux_layout.nao), "ngrid": int(np.asarray(env.grid_weights).size),
           "metric": {"kept": int(w.size), "condition": float(w.max() / w.min())}}
    if args.compare_fit:
        del B
        rec["compare_fit"] = _compare_fit(scf, mf)
    if args.solve or args.rayleigh is not None:
        s = time.perf_counter()
        held = [B]
        del B
        ref, data = _operators(mf, held, fe["fock_hf_ao"])
        seconds["operators"] = time.perf_counter() - s
        if args.solve:
            rec["solve"] = _solve(ref, data)
        if args.rayleigh is not None:
            s = time.perf_counter()
            rec["rayleigh"] = _certify(ref, data, args.rayleigh)
            seconds["rayleigh"] = time.perf_counter() - s
    rec["stage_seconds"] = seconds
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

"""The port's nuclear gradients (`xtddft_tpu_torch.grad`) against the JAX package's.

The JAX gradients cost a minute or more each on the CPU, so
`tools/grad_golden.py` ran them once into `tests/data/golden_torch_grad.json`
(its seed and commit inside), with each case's JAX mean field.  Here the
port's gradients run on that same mean field (its orbitals, orbital
energies and Fock matrices in a port MeanField on the port's own Env, CPU):

- `scf_gradient` (and `hf_gradient` for HF references) against JAX,
  1e-7 Ha/bohr for HF references, 1e-6 for KS ones;
- `ExcitedGradients.kernel` for every method (cis, cis-triplet, rtdhf,
  rtdhf-triplet on RHF H2O; xcis, sfcis-up, xtdhf on ROHF OH; ucis, utdhf
  on UHF OH; cis on RKS/SVWN H2; sfcis-up with the ALDA0 and the
  multicollinear kernels on ROKS/BHandHLYP OH at grid level 0) against
  JAX, same gates, and its states against the JAX states, 1e-8 Ha;
- `states()` (the Hessian of the quadratic form) against the port's
  drivers (`source="driver"`), 1e-8 Ha;
- the port's own finite differences on one atom, within the JAX tests'
  gates (5e-6 Ha/bohr for ground states, 2e-5 for excited states);
- the differentiable sfX2C core Hamiltonian and `sfx2c1e_diff` on HCl
  against JAX, 1e-10 of the largest entry, and their vjps against JAX
  (1e-6) and the coordinate vjp against central differences (1e-8; see the
  test).

One thread; no CH2O+/cc-pVDZ gradient here (that one runs on the card).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.grad import (ExcitedGradients, fd_excited_gradient, fd_gradient,
                                   hf_gradient, scf_gradient)
from xtddft_tpu_torch.scf.driver import MeanField, SCF
from xtddft_tpu_torch.scf.env import Env
from xtddft_tpu_torch.xc import registry


GOLDEN = json.loads((pathlib.Path(__file__).parent / "data" / "golden_torch_grad.json")
                    .read_text())["cases"]
HF_TOL = 1e-7  # Ha/bohr, against JAX on the same orbitals
KS_TOL = 1e-6  # the grid's quadrature adds its own round-off
STATES_TOL = 1e-8  # Ha
FD_GROUND_TOL = 5e-6  # tests/test_grad_analytic.py:44
FD_EXCITED_TOL = 2e-5  # tests/test_grad_analytic.py:66
SCF_CASES = ["h2o_rhf", "oh_rohf", "oh_uhf", "h2_rks_svwn", "oh_roks_bhandhlyp", "hcl_rhf_x2c"]
METHOD_CASES = [(c, m) for c in SCF_CASES for m in GOLDEN[c]["methods"]]

_MF = {}


def _mf(case):
    """The JAX mean field of a golden case as a port MeanField (CPU)."""
    if case not in _MF:
        g = GOLDEN[case]
        mol = Molecule.from_atoms(g["atoms"], basis=g["basis"], spin=g["spin"])
        env = Env(mol, grid_level=g["grid_level"], x2c=g["x2c"], device="cpu")
        arr = {k: np.asarray(v) for k, v in g["mf"].items()}
        _MF[case] = MeanField(mol=mol, env=env, kind=g["kind"],
                              xc=registry.resolve(g["xc"]) if g["xc"] else None,
                              e_tot=g["e_tot"], converged=True, **arr)
    return _MF[case]


def _tol(case):
    return KS_TOL if GOLDEN[case]["xc"] else HF_TOL


def _dev(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("case", SCF_CASES)
def test_scf_gradient_matches_jax(case):
    g = scf_gradient(_mf(case))
    assert _dev(g, GOLDEN[case]["scf_gradient"]) <= _tol(case)
    assert np.abs(g.sum(axis=0)).max() < 1e-8  # translational invariance


@pytest.mark.parametrize("case", ["h2o_rhf", "oh_rohf", "oh_uhf"])
def test_hf_gradient_matches_jax(case):
    """The analytic HF gradient, its two-electron term on K5's plain
    version, against JAX's host-loop version and against the autodiff
    ground-state gradient."""
    mf = _mf(case)
    g = hf_gradient(mf)
    assert _dev(g, GOLDEN[case]["hf_gradient"]) <= HF_TOL
    assert _dev(g, GOLDEN[case]["scf_gradient"]) <= HF_TOL


@pytest.mark.parametrize("case,method", METHOD_CASES, ids=[f"{c}-{m}" for c, m in METHOD_CASES])
def test_excited_gradient_matches_jax(case, method):
    gold = GOLDEN[case]["methods"][method]
    name, sf_method = method.split("/")
    eg = ExcitedGradients(_mf(case), method=name, sf_method=int(sf_method))
    e, _ = eg.states(len(gold["states_e"]))
    assert _dev(e, gold["states_e"]) <= STATES_TOL
    g, w = eg.kernel(state=gold["state"], nstates=len(gold["states_e"]))
    assert abs(w - gold["omega"]) <= STATES_TOL
    assert _dev(g, gold["grad"]) <= _tol(case)
    assert np.abs(g.sum(axis=0)).max() < 1e-8
    assert eg.stats["cg_iterations"] < 400


STATE_METHODS = [("h2o_rhf", "cis/0"), ("h2o_rhf", "rtdhf/0"), ("h2o_rhf", "rtdhf-triplet/0"),
                 ("oh_rohf", "xcis/0"), ("oh_rohf", "sfcis-up/0"), ("oh_rohf", "xtdhf/0"),
                 ("oh_uhf", "ucis/0"), ("oh_uhf", "utdhf/0"), ("h2_rks_svwn", "cis/0"),
                 ("oh_roks_bhandhlyp", "sfcis-up/0")]


@pytest.mark.parametrize("case,method", STATE_METHODS,
                         ids=[f"{c}-{m}" for c, m in STATE_METHODS])
def test_states_match_drivers(case, method):
    """The eigenvalues of the quadratic form's Hessian equal the port's
    drivers' (the zero-frequency spin rotation of an open-shell TDHF
    pencil is not among the drivers' roots, so the comparison starts above
    zero)."""
    name, sf_method = method.split("/")
    eg = ExcitedGradients(_mf(case), method=name, sf_method=int(sf_method))
    e_drv, v_drv = eg.states(3, source="driver")
    e_h = np.asarray(GOLDEN[case]["methods"][method]["states_e"])
    if eg.is_tdhf:
        e_h = e_h[e_h > 1e-6]
    assert _dev(e_drv[:3], e_h[:3]) <= STATES_TOL
    # the drivers' vectors in this module's layout give back their roots
    k0 = torch.zeros(eg.nk, dtype=torch.float64)
    for s in range(len(e_drv)):
        w = float(eg._omega_i(eg._ints0(), k0, torch.as_tensor(v_drv[:, s])))
        assert abs(w - e_drv[s]) <= STATES_TOL


@pytest.mark.parametrize("case", ["h2_rks_svwn", "oh_roks_bhandhlyp"])
def test_xc_grid_matches_host_grid(case):
    """At the reference geometry the moving grid of `grad/xcgrid.py` gives
    the exchange-correlation energy of the host grid (`grids/`, which prunes
    weights below 1e-14) on the same densities."""
    from xtddft_tpu_torch.grad.xcgrid import make_exc_fn
    from xtddft_tpu_torch.xc import interface as xci

    mf = _mf(case)
    env = mf.env
    dm = torch.as_tensor(mf.make_rdm1())
    dm = dm if dm.dim() == 3 else torch.stack([0.5 * dm, 0.5 * dm])
    exc = make_exc_fn(mf.mol, env.layout, mf.xc, level=env.grid_level)
    with torch.no_grad():
        e_moving = float(exc(torch.as_tensor(mf.mol.coords), dm[0], dm[1]))
        rho = [xci.cache_rho(env.ao, d) for d in dm]
        e_host = float(xci.eval_exc(mf.xc, env.grid_weights,
                                    (rho[0][0], rho[1][0], rho[0][1], rho[1][1])))
    assert abs(e_moving - e_host) <= 1e-12 * abs(e_host)


@pytest.fixture(scope="module")
def h2o():
    return SCF(Molecule.from_atoms("O 0 0 0; H 0 0 0.96; H 0.93 0 -0.25", basis="sto-3g"),
               "rhf", device="cpu").kernel()


@pytest.fixture(scope="module")
def oh_rohf():
    return SCF(Molecule.from_atoms("O 0 0 0; H 0 0 0.98", basis="sto-3g", spin=1), "rohf",
               device="cpu").kernel()


def test_scf_gradient_vs_fd(h2o):
    ga = scf_gradient(h2o)
    gf = fd_gradient(h2o, h=1e-3, atoms=[2])
    assert _dev(ga[2], gf[2]) < FD_GROUND_TOL


def test_ks_scf_gradient_vs_fd():
    mf = SCF(Molecule.from_atoms("H 0 0 0; H 0 0 0.8", basis="sto-3g"), "rks", xc="svwn",
             grid_level=1, device="cpu").kernel()
    ga = scf_gradient(mf)
    gf = fd_gradient(mf, h=1e-3, atoms=[1])
    assert _dev(ga[1], gf[1]) < FD_GROUND_TOL


def test_rtdhf_gradient_vs_fd(h2o):
    from xtddft_tpu_torch.methods.drivers import TDHF

    ga, _ = ExcitedGradients(h2o, method="rtdhf").kernel(state=0)
    gf = fd_excited_gradient(h2o, lambda m: TDHF(m, nstates=1), state=0, h=1e-3, atoms=[1])
    assert _dev(ga[1], gf[1]) < FD_EXCITED_TOL


def test_xcis_gradient_vs_fd(oh_rohf):
    from xtddft_tpu_torch.methods.drivers import XTDA

    ga, _ = ExcitedGradients(oh_rohf, method="xcis").kernel(state=1, nstates=2)
    gf = fd_excited_gradient(oh_rohf, lambda m: XTDA(m, nstates=2), state=1, h=1e-3,
                             components=[(1, 2)])
    assert abs(ga[1, 2] - gf[1, 2]) < FD_EXCITED_TOL


def _fd_along(fn, x, d, ct, eps):
    """Derivative of <ct, fn(x + e d)> at e = 0 along d: central differences
    at steps eps and eps/2, Richardson-extrapolated (error O(eps^4))."""
    def central(e):
        with torch.no_grad():
            return float(((fn(x + e * d) - fn(x - e * d)) * ct).sum()) / (2 * e)
    return (4.0 * central(0.5 * eps) - central(eps)) / 3.0


def test_x2c_hcore_and_vjps_match_jax():
    """The differentiable sfX2C core Hamiltonian (coordinates -> h) and the
    decoupling alone (t, v, w, s -> h1e) against JAX's, values to 1e-10 of
    the largest entry.  Their vjps: JAX's own carry an error of ~1e-7 of
    the largest entry here (its custom-jvp route at the c^2 scale of the
    metric-reduced Hamiltonian; central differences in the coordinates side
    with the port, to 1e-9), so they are held to JAX at 1e-6, and the
    coordinate vjp to Richardson-extrapolated central differences along a
    seeded direction at 1e-8."""
    from xtddft_tpu_torch import units
    from xtddft_tpu_torch.grad.x2c_diff import make_x2c_hcore_fn, sfx2c1e_diff
    from xtddft_tpu_torch.ints import diffints as D
    from xtddft_tpu_torch.soc.x2c import uncontract

    gold = GOLDEN["hcl_rhf_x2c"]["x2c"]
    mf = _mf("hcl_rhf_x2c")
    layout = mf.env.layout
    rng = np.random.default_rng(11)
    fn = make_x2c_hcore_fn(layout, units.C_AU)
    c = torch.tensor(mf.mol.coords, dtype=torch.float64, requires_grad=True)
    h = fn(c)
    hmax = np.abs(gold["hcore"]).max()
    assert _dev(h.detach(), gold["hcore"]) <= 1e-10 * hmax
    assert _dev(h.detach(), mf.env.hcore) <= 1e-9 * hmax  # the host decoupling
    ct = torch.as_tensor(gold["hcore_cotangent"])
    g = torch.autograd.grad(h, c, ct)[0]
    assert _dev(g, gold["hcore_vjp"]) <= 1e-6 * np.abs(gold["hcore_vjp"]).max()
    d = torch.as_tensor(rng.standard_normal(c.shape))
    fd = _fd_along(fn, c.detach(), d, ct, 2e-4)
    assert abs(float((g * d).sum()) - fd) <= 1e-8 * abs(fd)

    unc, _ = uncontract(layout)
    charges = np.asarray(unc.mol.charges, dtype=np.float64)
    cu = torch.tensor(unc.mol.coords, dtype=torch.float64)
    with torch.no_grad():
        mats = {k: cu.new_zeros((unc.nao, unc.nao)) for k in "STVW"}
        for pc in D._pair_classes(unc):
            s_blk, t_blk = D._overlap_kinetic(pc, cu)
            mats["S"] = D._scatter2(mats["S"], pc, s_blk)
            mats["T"] = D._scatter2(mats["T"], pc, t_blk)
            mats["V"] = D._scatter2(mats["V"], pc, D._nuclear(pc, cu, charges))
            mats["W"] = D._scatter2(mats["W"], pc, D._pvp(pc, cu, charges))
    ins = [mats[k].clone().requires_grad_(True) for k in "TVWS"]
    h1 = sfx2c1e_diff(*ins, units.C_AU)
    assert _dev(h1.detach(), gold["sfx2c1e"]) <= 1e-10 * np.abs(gold["sfx2c1e"]).max()
    ct1 = torch.as_tensor(gold["sfx2c1e_cotangent"])
    grads = torch.autograd.grad(h1, ins, ct1)
    for k, gk in zip("tvws", grads):
        want = np.asarray(gold["sfx2c1e_vjp"][k])
        assert _dev(gk, want) <= 1e-6 * np.abs(want).max(), k

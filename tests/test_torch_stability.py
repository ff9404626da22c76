"""The port's SCF internal stability against the JAX package, f64 on the CPU.

- ``df_hessian_operator``: the Hessian actions on a seeded batch of three
  kappa vectors against the JAX jvp-of-gradient operator, relative 1e-10
  for Hartree-Fock (H2 RHF and the stretched-H2 UHF saddle, OH UHF and
  ROHF) and 1e-8 for Kohn-Sham (H2 RKS with SVWN and with CAM-B3LYP, whose
  long-range exchange is the second K1 pass; OH ROKS/B3LYP); its
  preconditioner exactly, and its rotation to 1e-12;
- the lowest eigenvalue of both backends against the JAX package's, and
  the verdict: the DF backend's (1e-8 Ha: two Davidsons at a residual of
  1e-5) on every case (OH ROKS/B3LYP at grid 1 is unstable in both), the
  dense backend's (1e-9 Ha) on tests/test_stability.py's H2 cases;
- the port alone on tests/test_stability.py's physics: the saddle detected
  and left by ``stable_scf`` on both backends, the size guard and the
  ``auto`` routing.

The mean fields are the port's own DF SCFs (grid 1), carried into the JAX
package through the shared checkpoint format, so both packages see the same
orbitals.  The JAX DF backend is held through its own ``internal_stability``
with its operator built once per case (``df_hessian_operator`` patched to
return the one the action test compiled).
"""

import numpy as np
import pytest

from xtddft_tpu.scf import stability as jax_stability
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.scf import RHF
from xtddft_tpu_torch.scf.checkpoint import load_mf, save_mf
from xtddft_tpu_torch.scf.driver import SCF
from xtddft_tpu_torch.scf.stability import (
    df_hessian_operator,
    internal_stability,
    stable_scf,
)


H2 = "H 0 0 0; H 0 0 0.74"
H2_STRETCHED = "H 0 0 0; H 0 0 2.2"
OH = "O 0 0 0; H 0 0 0.97"
# name: (geometry, spin, kind, xc, relative tolerance of the actions)
CASES = {
    "h2_rhf": (H2, 0, "rhf", None, 1e-10),
    "h2_uhf_saddle": (H2_STRETCHED, 0, "uhf", None, 1e-10),
    "oh_uhf": (OH, 1, "uhf", None, 1e-10),
    "oh_rohf": (OH, 1, "rohf", None, 1e-10),
    "h2_svwn": (H2, 0, "rks", "svwn", 1e-8),
    "h2_camb3lyp": (H2, 0, "rks", "cam-b3lyp", 1e-8),
    "oh_roks_b3lyp": (OH, 1, "roks", "b3lyp", 1e-8),
}
DENSE_CASES = ("h2_rhf", "h2_uhf_saddle", "h2_svwn")
DF_W_HA = 1e-8
DENSE_W_HA = 1e-9


def _port_scf(name, df=True):
    geo, spin, kind, xc, _ = CASES[name]
    scf = SCF(Molecule.from_atoms(geo, basis="sto-3g", spin=spin), kind, xc=xc, grid_level=1,
              df=df, device="cpu")
    if name == "h2_uhf_saddle":
        # seeded from the RHF orbitals: the spin-symmetric saddle
        mf_r = RHF(Molecule.from_atoms(geo, basis="sto-3g"), df=df, device="cpu").kernel()
        return scf, scf.kernel(init=np.stack([mf_r.mo_coeff] * 2))
    return scf, scf.kernel()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{name: (JAX MeanField, port MeanField, JAX operator)}, lazily: the
    JAX operator (its jit) is made once per case."""
    tmp = tmp_path_factory.mktemp("stability")
    cache = {}

    def get(name):
        if name not in cache:
            _, mf = _port_scf(name)
            assert mf.converged
            path = str(tmp / f"{name}.npz")
            save_mf(mf, path)
            jmf = jax_load_mf(path, df=True)
            cache[name] = (jmf, load_mf(path, df=True, device="cpu"),
                           jax_stability.df_hessian_operator(jmf))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_hessian_actions_match_jax(pairs, name):
    jmf, mf, (jhvp, jhdiag, jrotate) = pairs(name)
    hvp, hdiag, rotate = df_hessian_operator(mf)
    # as many vectors as the Davidson's block (min(3, n)): the JAX action's
    # compilation for this shape is the one its internal_stability reuses
    n = jhdiag.shape[0]
    xs = np.random.default_rng(3).normal(size=(min(3, n), n))
    want = np.asarray(jhvp(xs))
    got = hvp(xs).numpy()
    rtol = CASES[name][4]
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())
    np.testing.assert_array_equal(hdiag, jhdiag)
    kvec = 0.2 * xs[0] / np.abs(xs[0]).max()
    np.testing.assert_allclose(rotate(kvec), jrotate(kvec), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_df_lowest_eigenvalue_matches_jax(pairs, name, monkeypatch):
    jmf, mf, jop = pairs(name)
    monkeypatch.setattr(jax_stability, "df_hessian_operator", lambda _: jop)
    j_stable, j_w, _ = jax_stability.internal_stability(jmf, backend="df")
    stable, w, _ = internal_stability(mf, backend="df")
    assert abs(w - j_w) < DF_W_HA
    assert stable == j_stable


@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_lowest_eigenvalue_matches_jax(pairs, name):
    jmf, mf, _ = pairs(name)
    j_stable, j_w, _ = jax_stability.internal_stability(jmf, backend="dense")
    stable, w, _ = internal_stability(mf, backend="dense")
    assert abs(w - j_w) < DENSE_W_HA
    assert stable == j_stable == (name != "h2_uhf_saddle")


@pytest.mark.parametrize("backend,df", [("dense", False), ("dense", True), ("df", True)],
                         ids=["dense_incore", "dense_on_df", "df"])
def test_saddle_detected_and_escaped(backend, df):
    """tests/test_stability.py's physics on the port: the spin-symmetric UHF
    solution of stretched H2 is a saddle, and the retry loop lands on the
    broken-symmetry minimum, lower in energy."""
    scf, mf_sym = _port_scf("h2_uhf_saddle", df=df)
    stable, w, _ = internal_stability(mf_sym, backend=backend)
    assert not stable and w < -1e-3
    mf_r = RHF(Molecule.from_atoms(H2_STRETCHED, basis="sto-3g"), df=df, device="cpu").kernel()
    mf_bs = stable_scf(scf, init=np.stack([mf_r.mo_coeff] * 2), backend=backend)
    assert mf_bs.e_tot < mf_sym.e_tot - 1e-4
    assert internal_stability(mf_bs, backend=backend)[0]


def test_size_guard_and_auto_routing(monkeypatch):
    """Above 140 AO the dense backend refuses; ``auto`` takes the DF backend
    there and on an x2c core Hamiltonian (JAX `scf/stability.py:185-191`)."""
    from xtddft_tpu_torch.scf import stability

    class _Env:
        nao = 200
        x2c = False

    class _MF:
        env = _Env()
        v_ext = None

    with pytest.raises(NotImplementedError):
        internal_stability(_MF(), backend="dense")
    seen = []
    monkeypatch.setattr(stability, "_internal_stability_df",
                        lambda mf, tol, record: seen.append(mf.env.nao) or (True, 1.0, None))
    internal_stability(_MF(), backend="auto")
    _MF.env.nao, _MF.env.x2c = 10, True
    internal_stability(_MF(), backend="auto")
    assert seen == [200, 10]

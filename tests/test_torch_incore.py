"""The port's in-core route against the JAX package's, f64, CPU.

The in-core Env (`scf/env.py`: the 4-center tensor, J and K as products with
it), the SCF with ``df=False`` and ``df=None``, the XC terms of the in-core
response (`xc/interface.py fxc_v1mat`, `sf_v1mat`, `xc/mcol.py
sf_v1mat_mcol`, and the ``hermi=False`` density through the hermitian
kernel mode), `response/moeri.py`, the in-core sigma operators
(`response/sigma.py`, `sigma_xsf.py`) on a seeded block, and the symmetry
helper `scf/occupations.py` (its labels from `chem/symmetry.py`).

The reference state is the JAX session fixture ``fh_roks`` (FH triplet,
6-31G, BHandHLYP, grid 1, in-core SCF) carried into the port through the
shared checkpoint format, so both packages see the same orbitals: FH's two
triplet pi states lie ~6e-6 Ha apart at grid 1, and two SCFs may land in
different ones (ROADMAP fault 3.2).  The SCF's own parity is held on
OH/STO-3G ROKS/B3LYP, where the port's and the JAX package's SCFs land in
the same state (one new JAX SCF, grid 1).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xtddft_tpu.chem import Molecule as JaxMolecule
from xtddft_tpu.response import moeri as jax_moeri
from xtddft_tpu.response import sigma as jax_sigma
from xtddft_tpu.response import sigma_xsf as jax_sigma_xsf
from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf import ROKS as JaxROKS
from xtddft_tpu.scf.checkpoint import save_mf as jax_save_mf
from xtddft_tpu.scf.occupations import occ_from_irreps as jax_occ_from_irreps
from xtddft_tpu.xc import interface as jax_xci
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.methods import drivers
from xtddft_tpu_torch.response import moeri, sigma, sigma_xsf
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf import ROKS, SCF
from xtddft_tpu_torch.scf.checkpoint import load_mf
from xtddft_tpu_torch.scf.env import Env
from xtddft_tpu_torch.scf.occupations import occ_from_irreps
from xtddft_tpu_torch.xc import interface as xci
from xtddft_tpu_torch.xc import registry


OH = "O 0 0 0; H 0 0 0.97"
FH_SIGMA = {"A1": (4, 2), "B1": (1, 1), "B2": (1, 1)}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def fh(fh_roks, tmp_path_factory):
    """(JAX mean field, port mean field, JAX reference, port reference)."""
    path = str(tmp_path_factory.mktemp("incore") / "fh.npz")
    jax_save_mf(fh_roks, path)
    mf = load_mf(path, device="cpu")
    return fh_roks, mf, jax_make_reference(fh_roks), make_reference(mf)


def _dms(nao, n, seed, symmetric):
    d = np.random.default_rng(seed).normal(size=(n, nao, nao))
    return 0.5 * (d + d.transpose(0, 2, 1)) if symmetric else d


def test_incore_env_is_the_default(fh):
    _, mf, _, _ = fh
    assert not mf.env.df and not Env(mf.mol, device="cpu").df
    # the port builds the native engine itself: a few ulps from the JAX
    # package's build (ROADMAP's numerics note)
    _close(mf.env.eri, fh[0].env.eri, 1e-13)


@pytest.mark.parametrize("case", ["j", "k", "jk", "k_omega", "j_nonsym", "k_nonsym"])
def test_jk(fh, case):
    """J/K of the in-core Env against the JAX Env's einsums, elementwise."""
    jmf, mf, _, _ = fh
    jenv, env = jmf.env, mf.env
    sym = not case.endswith("nonsym")
    d = _dms(env.nao, 2, 7, sym)
    if case == "j":
        got, want = env.get_j(env.tensor(d[0])), jenv.get_j(jnp.asarray(d[0]))
    elif case == "k":
        got, want = env.get_k(env.tensor(d[0])), jenv.get_k(jnp.asarray(d[0]))
    elif case == "jk":
        J, K = env.get_jk(env.tensor(d))
        got = torch.cat([J[None], K])
        want = np.stack([jenv.get_j(jnp.asarray(d[0] + d[1])),
                         jenv.get_k(jnp.asarray(d[0])), jenv.get_k(jnp.asarray(d[1]))])
    elif case == "k_omega":
        omega = registry.resolve("camb3lyp").omega
        got = env.get_jk(env.tensor(d), omega=omega, with_j=False)[1]
        want = np.stack([jenv.get_k(jnp.asarray(x), omega=omega) for x in d])
    elif case == "j_nonsym":
        got = env.incore_j(env.tensor(d))
        want = jnp.einsum("pqrs,xsr->xpq", jenv.eri, jnp.asarray(d))
    else:
        got = env.incore_k(env.tensor(d))
        want = jnp.einsum("prsq,xrs->xpq", jenv.eri, jnp.asarray(d))
    _close(got, want, 1e-10)


@pytest.fixture(scope="module")
def oh_jax():
    mol = JaxMolecule.from_atoms(OH, basis="sto-3g", spin=1)
    return JaxROKS(mol, xc="b3lyp", grid_level=1).kernel()


@pytest.mark.parametrize("df", [False, None], ids=["df_false", "df_none"])
def test_scf_energy(oh_jax, df):
    """The in-core SCF, asked for or picked by size (7 AO), against the JAX
    package's in-core SCF on the same molecule."""
    scf = ROKS(Molecule.from_atoms(OH, basis="sto-3g", spin=1), xc="b3lyp", grid_level=1,
               df=df, device="cpu")
    mf = scf.kernel()
    assert not scf.env.df and mf.converged and oh_jax.converged
    assert abs(mf.e_tot - oh_jax.e_tot) < 1e-8


@pytest.mark.parametrize("seed", [3, 4])
def test_cache_rho_nonhermitian(fh, seed):
    """rho and grad rho of non-symmetric matrices through the hermitian
    kernel mode on (D + D^T)/2, against the JAX ``hermi=False`` einsums."""
    jmf, mf, _, _ = fh
    d = _dms(mf.env.nao, 2, seed, symmetric=False)
    r, g = xci.cache_rho(mf.env.ao, mf.env.tensor(d), hermi=False)
    for x in range(2):
        jr, jg = jax_xci.cache_rho(jmf.env.ao, jnp.asarray(d[x]), hermi=False)
        _close(r[x], jr, 1e-14 * float(np.abs(jr).max()))
        _close(g[x], jg, 1e-14 * float(np.abs(jg).max()))


def _transition(nao, nset, seed, spin_pair=True):
    shape = (nset, 2, nao, nao) if spin_pair else (nset, nao, nao)
    return 0.1 * np.random.default_rng(seed).normal(size=shape)


def test_fxc_v1mat(fh):
    """The perturbed XC matrices of non-symmetric alpha/beta pairs."""
    _, _, jref, ref = fh
    d = _transition(ref.env.nao, 3, 11)
    want = jax_xci.fxc_v1mat(jref.spec, jref.env.ao, jref.env.grid_weights,
                             jax_sigma._rho0_jnp(jref), jnp.asarray(d), hermi=False)
    got = xci.fxc_v1mat(ref.spec, ref.env.ao, ref.env.grid_weights, sigma._rho0(ref),
                        ref.env.tensor(d), hermi=False)
    _close(got, want, 1e-9)


def test_sf_v1mat(fh):
    """The ALDA0 spin-flip response matrices of non-symmetric transition
    matrices (the multicollinear ones through the operator below)."""
    _, _, jref, ref = fh
    d = _transition(ref.env.nao, 3, 12, spin_pair=False)
    want = jax_xci.sf_v1mat(jref.env.ao, jax_xci.sf_kernel_alda0(
        jref.spec, jref.env.grid_weights, jax_sigma._rho0_jnp(jref)), jnp.asarray(d))
    got = xci.sf_v1mat(ref.env.ao, xci.sf_kernel_alda0(ref.spec, ref.env.grid_weights,
                                                       sigma._rho0(ref)), ref.env.tensor(d))
    _close(got, want, 1e-9)


def test_mo_eri(fh):
    """Quarter transforms on blocks of four different widths."""
    _, _, jref, ref = fh
    mo = ref.mo_a
    cs = (mo[:, :3], mo[:, 2:9], mo[:, 5:6], mo[:, 1:])
    _close(moeri.mo_eri(ref.env.eri, *cs), jax_moeri.mo_eri(jref.env.eri, *cs), 1e-10)


def test_pair_features(fh):
    """The occupied-virtual pair features of the dense fxc tensor on a span
    of 700 grid points."""
    from xtddft_tpu.response import fxc_tensor as jax_fxc_tensor
    from xtddft_tpu_torch.response import fxc_tensor

    _, _, jref, ref = fh
    want = jax_fxc_tensor.pair_features(jref.env.ao[:, :700], jref.orbo_a, jref.orbv_a)
    got = fxc_tensor.mo_pair_features(ref.env.ao[:, :700], ref.env.tensor(ref.orbo_a),
                                      ref.env.tensor(ref.orbv_a)).permute(1, 2, 0)
    _close(got, want, 1e-12)


OPERATORS = {
    "xtda": (lambda r: jax_sigma.xtda_sigma_operator(r), lambda r: sigma.xtda_sigma_operator(r)),
    "utda": (lambda r: jax_sigma.utda_sigma_operator(r), lambda r: sigma.utda_sigma_operator(r)),
    "sf_up": (lambda r: jax_sigma.sf_sigma_operator(r, "up", 0),
              lambda r: sigma.sf_sigma_operator(r, "up", 0)),
    "sf_down": (lambda r: jax_sigma.sf_sigma_operator(r, "down", 0),
                lambda r: sigma.sf_sigma_operator(r, "down", 0)),
    "xsf_sa0": (lambda r: jax_sigma_xsf.xsf_sigma_operator(r, SA=0, remove=False),
                lambda r: sigma_xsf.xsf_sigma_operator(r, SA=0, remove=False)),
    "xsf_sa3": (lambda r: jax_sigma_xsf.xsf_sigma_operator(r, SA=3, fglobal=0.65),
                lambda r: sigma_xsf.xsf_sigma_operator(r, SA=3, fglobal=0.65)),
}


def check_operator(jop, op, seed):
    """An in-core operator on a seeded block of 5 vectors against the JAX
    operator, with its diagonal and blocked layout."""
    assert op.dim == jop.dim
    np.testing.assert_allclose(op.hdiag, np.asarray(jop.hdiag), rtol=0, atol=1e-12)
    z = np.random.default_rng(seed).normal(size=(5, op.dim))
    _close(op.matvec(torch.as_tensor(z)), jop.matvec(jnp.asarray(z)), 1e-9)
    np.testing.assert_allclose(op.to_blocked(z.T), np.asarray(jop.to_blocked(z.T)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator_matvec(fh, name):
    """Each in-core operator (the multicollinear SF-down one is in
    tests/test_torch_dense.py, beside the dense builders that share its
    kernel)."""
    _, _, jref, ref = fh
    jmake, make = OPERATORS[name]
    check_operator(jmake(jref), make(ref), len(name))


def test_occ_from_irreps(fh):
    """The FH 3Sigma occupation of the XSF-TDA goldens, by irrep counts."""
    jmf, mf, _, _ = fh
    (oa, ob), init = occ_from_irreps(mf, FH_SIGMA)
    (joa, job), jinit = jax_occ_from_irreps(jmf, FH_SIGMA)
    assert (list(oa), list(ob)) == (list(joa), list(job))
    np.testing.assert_allclose(init, np.asarray(jinit), rtol=0, atol=1e-10)


def test_closed_shell_reference():
    """An RKS reference has no open shell, and TDA refuses an open one."""
    mf = SCF(Molecule.from_atoms("H 0 0 0; F 0 0 0.92", basis="sto-3g"), "rks", xc="b3lyp",
             grid_level=1, device="cpu").kernel()
    ref = make_reference(mf)
    assert ref.no == 0 and ref.nc == 5 and not ref.restricted_open
    oh = SCF(Molecule.from_atoms(OH, basis="sto-3g", spin=1), "rohf", device="cpu").kernel()
    with pytest.raises(ValueError, match="closed-shell"):
        drivers.TDA(oh)

"""The port at the production basis (dzp: d shells, the "jk" aux recipe)
against the JAX package, f64 on the CPU, on OH/dzp ROKS/B3LYP, grid level 1,
density fitted with the "jk" aux recipe.  The port runs the SCF; the JAX
package only reads its checkpoint (one JAX DF build in this file, no JAX
SCF):

(a) the port's SCF saved with ``save_mf`` loads in the JAX ``load_mf``;
(b) the host layer at dzp against the JAX Env: S, hcore, the dipole,
    nabla and angular-momentum integrals, the AO values on the grid, j3c and
    the metric to 1e-12, metric^-1/2 and B to the
    conditioning-scaled tolerance of `test_torch_host_layer.py`;
(c) the JAX Fock build's energy of the port's density is the port's e_tot;
(d) the JAX ``XTDA`` and ``XSFTDA(SA=0)`` over DF on the loaded mean field
    give the port's roots;
(e) the port's SCF from the STO-3G solution projected to dzp lands on the
    energy of its SCF from the GWH guess, and the projection is the JAX
    package's (ROHF: see below);
(f) ``Env.df_B`` releases the host j3c once dressed, and every DF entry
    point still works after it.

OH has a half-filled pi pair.  Under ROKS/B3LYP the projected start and the
GWH start converge into its two pi states, which the level-1 grid splits by
6.2e-6 Ha; without a grid (ROHF) the two are degenerate to rounding, so (e)
holds the projected start there, to 1e-9 Ha.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xtddft_tpu.chem import Molecule as JaxMolecule
from xtddft_tpu.ints import build_layout as jax_build_layout
from xtddft_tpu.methods.drivers import XSFTDA as JaxXSFTDA
from xtddft_tpu.methods.drivers import XTDA as JaxXTDA
from xtddft_tpu.scf import project as jax_project
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu.scf.driver import SCF as JaxSCF
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.ints import build_layout
from xtddft_tpu_torch.methods.drivers import XSFTDA, XTDA
from xtddft_tpu_torch.scf import ROHF, ROKS, project
from xtddft_tpu_torch.scf.checkpoint import save_mf
from xtddft_tpu_torch.scf.env import Env

# the suite runs one worker process per core; torch's own intra-op threads
# would only contend with them
torch.set_num_threads(1)

OH = "O 0 0 0; H 0 0 0.97"
SETTINGS = dict(xc="b3lyp", grid_level=1, df=True, aux_mode="jk")
ATOL = 1e-12


def _oh(basis):
    return Molecule.from_atoms(OH, basis=basis, spin=1)


@pytest.fixture(scope="module")
def port_scf():
    scf = ROKS(_oh("dzp"), device="cpu", **SETTINGS)
    return scf, scf.kernel()


@pytest.fixture(scope="module")
def jax_mf(port_scf, tmp_path_factory):
    path = tmp_path_factory.mktemp("dzp") / "oh_dzp.npz"
    save_mf(port_scf[1], str(path))
    return jax_load_mf(str(path))


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_checkpoint_loads_in_jax(port_scf, jax_mf):
    """(a) The port's dzp state in the JAX package: the same arrays, d shells
    and the "jk" aux basis."""
    mf = port_scf[1]
    assert mf.converged
    for k in ("mo_coeff", "mo_energy", "mo_occ", "fock_a", "fock_b"):
        np.testing.assert_array_equal(np.asarray(getattr(jax_mf, k)), getattr(mf, k))
    assert jax_mf.env.aux_mode == mf.env.aux_mode == "jk"
    assert jax_mf.env.nao == mf.env.nao
    assert jax_mf.env.aux_layout.nao == mf.env.aux_layout.nao
    assert max(sh.l for sh in mf.env.layout.shells) == 2


@pytest.mark.parametrize("name", ["S", "hcore", "dip", "ipovlp", "rxp", "ao", "j3c", "metric"])
def test_host_layer_at_dzp(port_scf, jax_mf, name):
    """(b) The integrals (the one-electron ones of the properties too) and the
    grid's AO values of the two packages to 1e-12."""
    from xtddft_tpu.ints.two_electron import eri_2c as jax_eri_2c
    from xtddft_tpu_torch.ints.two_electron import eri_2c

    tenv, jenv = port_scf[1].env, jax_mf.env
    if name == "j3c":
        got, want = tenv.df_j3c_host(), jenv.df_j3c_host()
    elif name == "metric":
        got, want = eri_2c(tenv.aux_layout), jax_eri_2c(jenv.aux_layout)
    else:
        got, want = getattr(tenv, name), getattr(jenv, name)
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fitted_tensor_at_dzp(port_scf, jax_mf):
    """(b) metric^-1/2 and B, to the tolerance the metric's conditioning
    leaves (the two engines' metrics differ by a few ulps)."""
    tenv, jenv = port_scf[1].env, jax_mf.env
    want = jenv.df_isqrt_host()
    np.testing.assert_allclose(tenv.df_isqrt_host(), want, rtol=0,
                               atol=1e-7 * np.abs(want).max())
    want = jenv.df_B_host()
    np.testing.assert_allclose(tenv.df_B_host(), want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_jax_energy_of_the_port_density(port_scf, jax_mf):
    """(c) One JAX Fock build on the port's converged density gives the
    port's e_tot within 1e-10 Ha."""
    mf = port_scf[1]
    da, db = mf.make_rdm1()
    jscf = JaxSCF(jax_mf.mol, "roks", xc="b3lyp", env=jax_mf.env)
    e2 = float(jscf._veff_and_exc(jnp.asarray(da), jnp.asarray(db))[2])
    h = _host(jax_mf.env.hcore)
    e = float(np.einsum("pq,qp->", h, da + db)) + e2 + jax_mf.mol.energy_nuc()
    assert abs(e - mf.e_tot) <= 1e-10


@pytest.mark.parametrize("method", ["xtda", "xsf"])
def test_responses_at_dzp(port_scf, jax_mf, method):
    """(d) The DF responses of both packages on one state, roots within 1e-8 eV."""
    mf = port_scf[1]
    if method == "xtda":
        want = JaxXTDA(jax_mf, nstates=5, backend="df").kernel()
        got = XTDA(mf, nstates=5, backend="df").kernel()
    else:
        want = JaxXSFTDA(jax_mf, nstates=4, SA=0, backend="df").kernel()
        got = XSFTDA(mf, nstates=4, SA=0, backend="df").kernel()
        np.testing.assert_allclose(got.ds2, np.asarray(want.ds2), rtol=0, atol=1e-6)
    assert got.converged and want.converged
    np.testing.assert_allclose(got.e_eV, np.asarray(want.e_eV), rtol=0, atol=1e-8)


def test_projected_guess_at_dzp(port_scf):
    """(e) The STO-3G solution projected to dzp (d shells in the cross
    overlap) starts the port's ROHF on the energy of its GWH start, within
    1e-9 Ha; the projection is the JAX package's to 1e-10."""
    env = port_scf[0].env
    small = ROHF(_oh("sto-3g"), df=True, aux_mode="jk", device="cpu").kernel()
    big = env.layout
    jsmall = jax_build_layout(JaxMolecule.from_atoms(OH, basis="sto-3g", spin=1))
    jbig = jax_build_layout(JaxMolecule.from_atoms(OH, basis="dzp", spin=1))
    np.testing.assert_allclose(project.cross_overlap(big, small.env.layout),
                               jax_project.cross_overlap(jbig, jsmall), rtol=0, atol=1e-12)
    init = project.project_mo(small.mo_coeff, small.env.layout, big)
    np.testing.assert_allclose(init, jax_project.project_mo(small.mo_coeff, jsmall, jbig),
                               rtol=0, atol=1e-10)
    gwh = ROHF(_oh("dzp"), env=env).kernel()
    got = ROHF(_oh("dzp"), env=env).kernel(init=init)
    assert got.converged and gwh.converged
    assert abs(got.e_tot - gwh.e_tot) <= 1e-9


def test_df_b_releases_the_host_j3c():
    """(f) Once ``df_B`` has dressed the host j3c it holds none; a second
    ``df_B`` comes from its cache, ``df_B_host`` from it, and a later
    ``df_j3c_host`` rebuilds the same integrals."""
    env = Env(_oh("sto-3g"), grid_level=1, df=True, aux_mode="jk", device="cpu",
              dtype=torch.float64)
    j3c = env.df_j3c_host().copy()
    B = env.df_B()
    assert not env._df_j3c_cache
    assert env.df_B(0.0) is B
    np.testing.assert_array_equal(env.df_B_host(), B.numpy())
    np.testing.assert_array_equal(env.df_j3c_host(), j3c)
    assert env.df_B() is B

"""The port's SCF (`xtddft_tpu_torch/scf/`) against the JAX package's, f64, CPU.

One Fock build on the same density matrices, the whole SCF (FH ROKS against
the session fixture ``fh_roks_df``, one NH2 UKS), DIIS and the Roothaan
Fock on seeded inputs, the parts that raise, the SCF -> X-TDA chain, the
shared checkpoint format both ways and the named geometries.  On CPU
tensors every kernel wrapper runs its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xtddft_tpu.chem import Molecule as JaxMolecule
from xtddft_tpu.chem import geometries as jax_geometries
from xtddft_tpu.methods.drivers import XTDA as JaxXTDA
from xtddft_tpu.scf import UKS as JaxUKS
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu.scf.checkpoint import save_mf as jax_save_mf
from xtddft_tpu.scf.diis import DIIS as JaxDIIS
from xtddft_tpu.scf.driver import SCF as JaxSCF
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.chem import geometries
from xtddft_tpu_torch.methods.drivers import XTDA
from xtddft_tpu_torch.scf import ROKS, SCF, UKS
from xtddft_tpu_torch.scf.checkpoint import load_mf, save_mf
from xtddft_tpu_torch.scf.diis import DIIS
from xtddft_tpu_torch.scf.env import Env

FH = "F 0 0 0; H 0 0 1.0"
# the UKS case: a bent radical, with no degenerate pair at the Fermi level
# (OH's half-filled pi pair lets the aufbau occupation flip between the
# two orbitals from one cycle to the next; the JAX UKS on OH/STO-3G/SVWN
# oscillates between two states and does not converge in 200 cycles)
NH2 = "N 0 0 0; H 0 0.8 0.6; H 0 -0.8 0.6"
# Fock builds of the JAX package's ROKS on the fixture's input (fh_roks_df),
# counted by wrapping its `_veff_and_exc`; the fixture does not keep it
JAX_FH_CYCLES = 19


def _fh():
    return Molecule.from_atoms(FH, basis="6-31g", spin=2)


@pytest.fixture(scope="module")
def fh_env():
    return Env(_fh(), grid_level=1, df=True, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def fh_port_scf(fh_env):
    scf = ROKS(_fh(), xc="bhandhlyp", grid_level=1, df=True, env=fh_env)
    scf.profile = True
    return scf, scf.kernel()


def _densities(mf, seed):
    """Seeded symmetric positive semi-definite pair near the converged one."""
    rng = np.random.default_rng(seed)
    c = np.asarray(mf.mo_coeff)
    occ = np.asarray(mf.mo_occ)
    ca = c[:, occ >= 1] + 0.05 * rng.normal(size=(c.shape[0], int((occ >= 1).sum())))
    cb = c[:, occ >= 2] + 0.05 * rng.normal(size=(c.shape[0], int((occ >= 2).sum())))
    return ca @ ca.T, cb @ cb.T


@pytest.mark.parametrize("kind,xc", [("roks", "bhandhlyp"), ("rks", "b3lyp"), ("uks", "svwn"),
                                     ("uhf", None)])
def test_fock_build_matches_jax(fh_roks_df, fh_env, kind, xc):
    """(a) One Fock build, no iterations: veff rel <= 1e-10, e2 <= 1e-10 Ha."""
    da, db = _densities(fh_roks_df, 11)
    want_a, want_b, want_e2 = JaxSCF(fh_roks_df.mol, kind, xc=xc, env=fh_roks_df.env)\
        ._veff_and_exc(jnp.asarray(da), jnp.asarray(db))
    got_a, got_b, got_e2 = SCF(_fh(), kind, xc=xc, env=fh_env)._veff_and_exc(da, db)
    for got, want in ((got_a, want_a), (got_b, want_b)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    assert abs(got_e2 - want_e2) <= 1e-10


def test_env_jk_matches_jax(fh_roks_df, fh_env):
    """`Env.get_j`, `get_k` (K1 in AO mode) and `get_jk` (one launch for a
    stack) against the JAX Env's DF J and K."""
    da, db = _densities(fh_roks_df, 12)
    jenv, t = fh_roks_df.env, torch.as_tensor
    J, K = fh_env.get_jk(t(np.stack([da, db])))
    for got, want in ((fh_env.get_j(t(da)), jenv.get_j(jnp.asarray(da))),
                      (fh_env.get_k(t(db)), jenv.get_k(jnp.asarray(db))),
                      (J, jenv.get_j(jnp.asarray(da + db))),
                      (K[0], jenv.get_k(jnp.asarray(da))), (K[1], jenv.get_k(jnp.asarray(db)))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_range_separated_fock_build(fh_roks_df, fh_env):
    """The RSH branch of the Fock build (CAM-B3LYP: K of the Coulomb tensor
    and of the erf-attenuated one, both on K1) against its terms assembled
    by einsums from the Env's fitted tensors."""
    from xtddft_tpu_torch.xc import interface as xci
    from xtddft_tpu_torch.xc.registry import resolve

    spec = resolve("camb3lyp")
    da, db = _densities(fh_roks_df, 13)
    va, vb, e2 = SCF(_fh(), "uks", xc="camb3lyp", env=fh_env)._veff_and_exc(da, db)
    dms = torch.as_tensor(np.stack([da, db]))

    def k_of(B):
        return torch.einsum("Pmr,xrs,Psn->xmn", B, dms, B)

    B = fh_env.df_B()
    J = torch.einsum("Pmn,P->mn", B, torch.einsum("Pls,sl->P", B, dms[0] + dms[1]))
    k = spec.hyb * k_of(B) + (spec.alpha - spec.hyb) * k_of(fh_env.df_B(spec.omega))
    r, g = xci.cache_rho(fh_env.ao, dms)
    exc, Va, Vb = xci.vxc_matrices(spec, fh_env.ao, fh_env.grid_weights,
                                   (r[0], r[1], g[0], g[1]))
    for got, want in ((va, J + Va - k[0]), (vb, J + Vb - k[1])):
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12 * float(want.abs().max()))
    e2_want = 0.5 * torch.sum((dms[0] + dms[1]) * J) - 0.5 * torch.sum(dms * k) + exc
    assert abs(e2 - float(e2_want)) <= 1e-10


def test_roks_scf_matches_jax(fh_roks_df, fh_port_scf):
    """(b) FH ROKS/BHandHLYP DF from the GWH guess against the fixture; the
    profiled stages of its Fock builds are the documented ones."""
    scf, mf = fh_port_scf
    assert set(scf.stage_seconds) == {"host", "upload", "jk", "rho", "xc",
                                      "download"}
    assert mf.converged and fh_roks_df.converged
    assert abs(mf.e_tot - fh_roks_df.e_tot) <= 1e-8
    np.testing.assert_allclose(mf.mo_energy, fh_roks_df.mo_energy, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mf.mo_occ, fh_roks_df.mo_occ)
    assert abs(scf.cycles - JAX_FH_CYCLES) <= 2


def test_uks_scf_matches_jax():
    """(b) NH2 UKS/SVWN STO-3G DF, cycles counted on both sides."""
    want_scf = JaxUKS(JaxMolecule.from_atoms(NH2, basis="sto-3g", spin=1), xc="svwn",
                      grid_level=1, df=True)
    calls = [0]
    build = want_scf._veff_and_exc

    def counted(*args):
        calls[0] += 1
        return build(*args)

    want_scf._veff_and_exc = counted
    want = want_scf.kernel()
    scf = UKS(Molecule.from_atoms(NH2, basis="sto-3g", spin=1), xc="svwn", grid_level=1,
              df=True, device="cpu")
    got = scf.kernel()
    assert got.converged and want.converged
    assert abs(got.e_tot - want.e_tot) <= 1e-8
    np.testing.assert_allclose(got.mo_energy, want.mo_energy, rtol=0, atol=1e-6)
    assert abs(scf.cycles - calls[0]) <= 2
    np.testing.assert_allclose(got.spin_square(), want.spin_square(), rtol=0, atol=1e-8)


def test_diis_matches_jax():
    """(c) DIIS extrapolation over more updates than its space holds."""
    rng = np.random.default_rng(3)
    got, want = DIIS(4), JaxDIIS(4)
    for _ in range(6):
        f, e = rng.normal(size=30), rng.normal(size=30)
        np.testing.assert_allclose(got.update(f, e), want.update(f, e), rtol=0, atol=1e-12)


def test_roothaan_fock_matches_jax(fh_roks_df, fh_env):
    """(c) The Roothaan effective Fock on seeded Fock and density matrices."""
    rng = np.random.default_rng(4)
    n = fh_env.nao

    def sym(a):
        return a + a.T

    fa, fb = sym(rng.normal(size=(n, n))), sym(rng.normal(size=(n, n)))
    da, db = _densities(fh_roks_df, 5)
    S = np.asarray(fh_roks_df.env.S)
    want = JaxSCF._roothaan_fock(None, fa, fb, db, da - db, S)
    got = SCF._roothaan_fock(None, fa, fb, db, da - db, S)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("kw", [{"df": False}, {"engine": "device"}, {"x2c": True}],
                         ids=["in_core", "device_engine", "x2c"])
def test_unported_parts_raise(kw):
    """(d) Each part the port does not have yet raises, naming its item.  The
    in-core ERIs are ported since (tests/test_torch_incore.py): that case
    now builds an in-core Env.  The meta-GGA SCF is ported since
    (tests/test_torch_functionals.py).  x2c is ported since
    (tests/test_torch_soc.py): that case now builds an x2c Env."""
    kw = {"xc": "b3lyp", **kw}
    if kw.get("df") is False:
        assert not SCF(_fh(), "roks", grid_level=1, device="cpu", **kw).env.df
        return
    if kw.get("x2c"):
        assert SCF(_fh(), "roks", grid_level=1, device="cpu", **kw).env.x2c
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SCF(_fh(), "roks", grid_level=1, device="cpu", **kw)


def test_scf_to_xtda_matches_jax(fh_roks_df, fh_port_scf):
    """(e) The slice as a whole: the port's SCF, then X-TDA over DF, against
    the JAX chain from fh_roks_df."""
    want = JaxXTDA(fh_roks_df, nstates=5, backend="df").kernel()
    got = XTDA(fh_port_scf[1], nstates=5, backend="df").kernel()
    assert got.converged and want.converged
    np.testing.assert_allclose(got.e_eV, want.e_eV, rtol=0, atol=1e-6)


_KEYS = ("mo_coeff", "mo_energy", "mo_occ", "fock_a", "fock_b")


def test_checkpoint_round_trip(tmp_path, fh_roks_df, fh_port_scf):
    """A port checkpoint loads in the JAX load_mf and a JAX one in the port's,
    with equal arrays and the same molecule and settings."""
    mf = fh_port_scf[1]
    save_mf(mf, str(tmp_path / "port.npz"))
    back = jax_load_mf(str(tmp_path / "port.npz"))
    jax_save_mf(fh_roks_df, str(tmp_path / "jax.npz"))
    fwd = load_mf(str(tmp_path / "jax.npz"), device="cpu")
    for src, dst in ((mf, back), (fh_roks_df, fwd)):
        for k in _KEYS:
            np.testing.assert_array_equal(np.asarray(getattr(dst, k)), np.asarray(getattr(src, k)))
        assert (dst.e_tot, dst.converged, dst.kind, dst.xc.name) == \
            (src.e_tot, src.converged, src.kind, src.xc.name)
        assert dst.mol.symbols == src.mol.symbols and dst.mol.spin == src.mol.spin
        np.testing.assert_array_equal(dst.mol.coords, src.mol.coords)
        assert (dst.env.grid_level, dst.env.df, dst.env.aux_beta) == \
            (src.env.grid_level, src.env.df, src.env.aux_beta)


def test_geometries_match_jax():
    """The port's named geometries are the JAX module's, name for name."""
    names = {k for k, v in vars(jax_geometries).items()
             if isinstance(v, str) and not k.startswith("_")}
    mine = {k for k, v in vars(geometries).items()
            if isinstance(v, str) and not k.startswith("_")}
    assert names == mine and "ttm_vacuum" in mine
    for k in names:
        assert getattr(geometries, k) == getattr(jax_geometries, k), k


def _layouts(basis):
    from xtddft_tpu.ints import build_layout as jax_build_layout
    from xtddft_tpu_torch.ints import build_layout

    return (build_layout(Molecule.from_atoms(FH, basis=basis, spin=2)),
            jax_build_layout(JaxMolecule.from_atoms(FH, basis=basis, spin=2)))


def test_sad_guess_matches_jax():
    """`scf/guess.py`: the SAD density (free-atom SCFs on the atoms' 4-center
    tensors) and its natural orbitals, against the JAX package's."""
    from xtddft_tpu.scf import guess as jax_guess
    from xtddft_tpu_torch.scf import guess

    layout, jax_layout = _layouts("6-31g")
    D, want = guess.sad_density(layout), jax_guess.sad_density(jax_layout)
    np.testing.assert_allclose(D, want, rtol=0, atol=1e-10)
    # natural orbitals: S-orthonormal, with the JAX package's occupations
    # (a rotation within a degenerate p shell is free)
    from xtddft_tpu_torch.ints import overlap

    S = overlap(layout)
    C, Cj = guess.sad_mo(layout), jax_guess.sad_mo(jax_layout)
    np.testing.assert_allclose(C.T @ S @ C, np.eye(C.shape[1]), rtol=0, atol=1e-10)
    occ = np.diag(C.T @ S @ D @ S @ C)
    np.testing.assert_allclose(occ, np.diag(Cj.T @ S @ want @ S @ Cj), rtol=0, atol=1e-10)


def test_projection_matches_jax():
    """`scf/project.py`: the cross overlap and the projected MOs, STO-3G
    into 6-31G."""
    from xtddft_tpu.scf import project as jax_project
    from xtddft_tpu_torch.scf import project

    (small, jax_small), (big, jax_big) = _layouts("sto-3g"), _layouts("6-31g")
    np.testing.assert_allclose(project.cross_overlap(big, small),
                               jax_project.cross_overlap(jax_big, jax_small), rtol=0, atol=1e-12)
    c = np.random.default_rng(6).normal(size=(small.nao, 4))
    np.testing.assert_allclose(project.project_mo(c, small, big),
                               jax_project.project_mo(c, jax_small, jax_big), rtol=0, atol=1e-10)

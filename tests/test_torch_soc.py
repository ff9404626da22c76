"""The port's spin-orbit layer against the JAX package, f64 on the CPU.

- the batched SO integrals: ``rinv_deriv2`` and ``nuclear_deriv2`` (OH,
  contracted STO-3G, two centers; and a seeded p and g shell of the As
  atom's uncontracted ano-dz basis) and the quartet blocks of
  ``kint_blocks`` (a seeded s, p, d, f and g shell of that basis, one
  center, the one-center route; OH over both centers, contracted), each
  block within 1e-12 of its largest element, floored at 1e-2 of the
  largest element of all blocks (a block that vanishes by symmetry holds
  rounding noise alone);
- sfX2C: ``sfx2c1e`` and the x2c Env's core Hamiltonian on the O atom
  (1e-10), and the x2c SCF through ``load_mf`` against the JAX x2c SCF;
- ``build_vso`` on the O atom, both two-electron routes ('full', 'direct')
  and both decouplings (x2c one-center, Breit-Pauli all-center), 1e-12
  of its largest element;
- ``wigner_w`` over every (S, M, S', M') up to S = 5/2, and ``SIDriver`` on
  the same synthetic states and Vso for S = 1/2, 1 and 3/2 (eso within
  1e-10 Ha, the transition dipoles in the states' basis within 1e-10);
- the slice as a whole: ``run_soc_si`` on the O atom's 3P term from the
  committed JAX checkpoint `tests/data/o_rohf_ckpt.npz`, against the JAX
  pipeline on it (levels within 0.01 cm^-1), with tests/test_soc_si.py's
  gates; and the stored JAX golden of `tools/stability_soc_golden.py`.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from xtddft_tpu.chem import Molecule as JaxMolecule
from xtddft_tpu.ints import build_layout as jax_build_layout
from xtddft_tpu.ints import soc_ints as jax_soc_ints
from xtddft_tpu.ints.shell import BasisLayout as JaxBasisLayout
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu.scf.driver import SCF as JaxSCF
from xtddft_tpu.scf.env import Env as JaxEnv
from xtddft_tpu.soc import si as jax_si
from xtddft_tpu.soc import somf as jax_somf
from xtddft_tpu.soc import x2c as jax_x2c
from xtddft_tpu.soc.pipeline import run_soc_si as jax_run_soc_si
from xtddft_tpu_torch import units
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.ints import build_layout, kinetic, nuclear_attraction, overlap, soc_ints
from xtddft_tpu_torch.ints.shell import BasisLayout
from xtddft_tpu_torch.scf.checkpoint import load_mf, save_mf
from xtddft_tpu_torch.scf.driver import SCF
from xtddft_tpu_torch.scf.env import Env
from xtddft_tpu_torch.soc import si, somf, x2c
from xtddft_tpu_torch.soc.pipeline import run_soc_si


DATA = pathlib.Path(__file__).parent / "data"
CM = units.HA2EV * units.EV2CM_1
OH = "O 0 0 0; H 0.3 0.2 0.97"
INT_RTOL = 1e-12


def _layouts(spec, basis, spin):
    return (jax_build_layout(JaxMolecule.from_atoms(spec, basis=basis, spin=spin)),
            build_layout(Molecule.from_atoms(spec, basis=basis, spin=spin)))


def _sub_layouts(ls, seed):
    """One seeded shell of each angular momentum in ``ls`` from the As atom's
    uncontracted ano-dz basis, as a layout of each package."""
    jl, pl = _layouts("As 0 0 0", "ano-dz", 3)
    junc, _ = jax_x2c.uncontract(jl)
    punc, _ = x2c.uncontract(pl)
    rng = np.random.default_rng(seed)
    pick = [int(rng.choice([i for i, s in enumerate(punc.shells) if s.l == l])) for l in ls]
    out = []
    for unc, cls in ((junc, JaxBasisLayout), (punc, BasisLayout)):
        shells, off = [], 0
        for i in pick:
            shells.append(dataclasses.replace(unc.shells[i], ao_offset=off))
            off += 2 * unc.shells[i].l + 1
        out.append(cls(mol=unc.mol, shells=tuple(shells), nao=off))
    return out


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("which", ["oh", "as_pg"])
def test_nuclear_derivative_integrals_match_jax(which):
    jl, pl = _layouts(OH, "sto-3g", 1) if which == "oh" else _sub_layouts((1, 4), seed=5)
    center = np.array([0.1, -0.2, 0.3])
    _close(soc_ints.rinv_deriv2(pl, center), jax_soc_ints.rinv_deriv2(jl, center), INT_RTOL)
    if which == "oh":
        for got, want in zip(soc_ints.nuclear_deriv2(pl), jax_somf.nuclear_deriv2(jl)):
            _close(got, want, INT_RTOL)


@pytest.mark.parametrize("which,use_1c", [("as_spdfg", True), ("oh", False), ("oh", True)])
def test_kint_blocks_match_jax(which, use_1c):
    """Every block of the JAX generator, keyed by its four shells' offsets;
    the port yields each (with its mirror) once as well."""
    jl, pl = (_sub_layouts(range(5), seed=11) if which == "as_spdfg"
              else _layouts(OH, "sto-3g", 1))

    def key(sa, sb, sc, sd):
        return (sa.start, sb.start, sc.start, sd.start)

    want = {key(*b[:4]): b[4] for b in jax_soc_ints.kint_blocks(jl, use_1c=use_1c)}
    got = {key(*b[:4]): b[4] for b in soc_ints.kint_blocks(pl, use_1c=use_1c, device="cpu")}
    assert got.keys() == want.keys()
    # a block that vanishes by symmetry, or nearly, holds the rounding noise
    # of intermediates of the size of the largest blocks: its scale is
    # floored at 1e-2 of the largest element of all blocks (so that its
    # elements are held to 1e-14 of that)
    floor = 1e-2 * max(np.abs(t).max() for t in want.values())
    ls = set()
    for k, t in want.items():
        np.testing.assert_allclose(got[k], t, rtol=0,
                                   atol=INT_RTOL * max(np.abs(t).max(), floor))
        ls.update(int(pl.ao_ls[i]) for i in k)
    if which == "as_spdfg":
        assert ls == {0, 1, 2, 3, 4}


def test_kint_tensor_matches_jax():
    jl, pl = _layouts("O 0 0 0", "sto-3g", 2)
    _close(soc_ints.kint(pl, device="cpu"), jax_soc_ints.kint(jl), INT_RTOL)
    # the host helpers shared with the JAX two-electron code
    from xtddft_tpu.ints import two_electron as jax_two_electron
    from xtddft_tpu_torch.ints import two_electron

    cart = np.random.default_rng(4).normal(size=6 * 3 * 10 * 1)
    np.testing.assert_array_equal(two_electron._sph4(cart, 2, 1, 3, 0),
                                  jax_two_electron._sph4(cart, 2, 1, 3, 0))
    np.testing.assert_array_equal(two_electron._comb_index(3, 4),
                                  jax_two_electron._comb_index(3, 4))
    np.testing.assert_array_equal(two_electron._herm_sign(5), jax_two_electron._herm_sign(5))


def test_sfx2c_matches_jax():
    jl, pl = _layouts("O 0 0 0", "sto-3g", 2)
    junc, jcontr = jax_x2c.uncontract(jl)
    punc, pcontr = x2c.uncontract(pl)
    np.testing.assert_array_equal(pcontr, jcontr)
    w_sf, _ = somf.nuclear_deriv2(punc)
    got = x2c.sfx2c1e(kinetic(punc), nuclear_attraction(punc), w_sf, overlap(punc), units.C_AU)
    jw, _ = jax_somf.nuclear_deriv2(junc)
    from xtddft_tpu.ints import kinetic as jk, nuclear_attraction as jv, overlap as js

    want = jax_x2c.sfx2c1e(jk(junc), jv(junc), jw, js(junc), units.C_AU)
    for g, w in zip(got, want):
        _close(g, w, 1e-10)
    mol = Molecule.from_atoms("O 0 0 0", basis="sto-3g", spin=2)
    h = Env(mol, x2c=True, device="cpu").hcore.numpy()
    want = JaxEnv(JaxMolecule.from_atoms("O 0 0 0", basis="sto-3g", spin=2),
                  x2c=True)._sfx2c_hcore()
    _close(h, want, 1e-10)


def test_x2c_scf_and_checkpoint_match_jax(tmp_path):
    """The port's x2c SCF against the JAX one, and its checkpoint loaded in
    both packages with the flag and the same core Hamiltonian."""
    mol = Molecule.from_atoms("O 0 0 0", basis="sto-3g", spin=2)
    mf = SCF(mol, "rohf", x2c=True, device="cpu").kernel()
    jmf = JaxSCF(JaxMolecule.from_atoms("O 0 0 0", basis="sto-3g", spin=2), "rohf",
                 x2c=True).kernel()
    assert mf.converged and abs(mf.e_tot - jmf.e_tot) < 1e-9
    save_mf(mf, str(tmp_path / "o_x2c.npz"))
    back = load_mf(str(tmp_path / "o_x2c.npz"), device="cpu")
    jback = jax_load_mf(str(tmp_path / "o_x2c.npz"))
    assert back.env.x2c and jback.env.x2c
    _close(back.env.hcore.numpy(), np.asarray(jback.env.hcore), 1e-10)


@pytest.fixture(scope="module")
def o_mfs():
    """The O atom's 3P ROHF from the committed JAX checkpoint, in both
    packages."""
    path = str(DATA / "o_rohf_ckpt.npz")
    return jax_load_mf(path), load_mf(path, device="cpu")


@pytest.fixture(scope="module")
def jax_vso(o_mfs):
    """The JAX Vso per decoupling, once: its 'full' and 'direct' routes agree
    to 1e-12 (tests/test_soc_ints.py)."""
    cache = {}

    def get(iop, use_1c):
        if iop not in cache:
            cache[iop] = jax_somf.build_vso(o_mfs[0], iop=iop, use_1c=use_1c, mf2e_impl="full")
        return cache[iop]

    return get


@pytest.mark.parametrize("impl", ["full", "direct"])
@pytest.mark.parametrize("iop,use_1c", [("x2c", True), ("bp", False)])
def test_build_vso_matches_jax(o_mfs, jax_vso, impl, iop, use_1c):
    _, mf = o_mfs
    want = jax_vso(iop, use_1c)
    got = somf.build_vso(mf, iop=iop, use_1c=use_1c, mf2e_impl=impl)
    for name in ("vso", "hso1e", "fso2e", "x", "rp"):
        _close(getattr(got, name), getattr(want, name), 1e-12)
    assert somf.resolve_mf2e_impl(10) == "direct"
    assert somf.resolve_mf2e_impl(159) == "direct"  # As: 3 nao^4 is 15.4 GB
    assert somf.resolve_mf2e_impl(159, "full") == "full"


def test_wigner_w_matches_jax():
    for S2 in range(1, 6):
        S = S2 / 2
        for Sp in (S - 1, S, S + 1):
            for M in np.arange(-S, S + 0.5):
                for Mp in np.arange(-Sp, Sp + 0.5):
                    args = (S, float(M), Sp, float(Mp))
                    assert si.wigner_w(*args) == pytest.approx(jax_si.wigner_w(*args),
                                                               abs=1e-14)


def _synthetic_states(rng, S, nc, no, nv, n):
    dims = {"S-": nc * nv + nc * no + no * nv + no * no + no,
            "S0": 2 * nc * nv + nc * no + no * nv if S > 0 else nc * nv + nc * no + no * nv,
            "S+": nc * nv}
    states = {}
    for man, dim in dims.items():
        if man == "S-" and S < 1:
            continue
        vs = []
        for k in range(n):
            x = rng.normal(size=dim)
            vs.append((0.1 * (k + 1) + 0.01 * rng.random(), x / np.linalg.norm(x)))
        states[man] = vs
    return states


@pytest.mark.parametrize("S", [0.5, 1.0, 1.5])
def test_si_driver_matches_jax(S):
    rng = np.random.default_rng(int(2 * S))
    no = int(round(2 * S))
    nc, nv = 3, 4
    nmo = nc + no + nv
    v = 1e-3 * rng.normal(size=(3, nmo, nmo))
    vso_mo = v - v.transpose(0, 2, 1)
    d = rng.normal(size=(3, nmo, nmo))
    dip = d + d.transpose(0, 2, 1)
    states = _synthetic_states(rng, S, nc, no, nv, 3)
    kw = dict(S=S, nc=nc, no=no, nv=nv, vso_mo=vso_mo, states=states, dip_mo=dip,
              mu_nuc=np.array([0.1, 0.2, 0.3]))
    want = jax_si.SIDriver(**kw)
    got = si.SIDriver(**kw)
    rw, rg = want.kernel(), got.kernel()
    np.testing.assert_allclose(rg.eso, rw.eso, rtol=0, atol=1e-10)
    np.testing.assert_allclose(rg.hso, rw.hso, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rg.esf, rw.esf, rtol=0, atol=1e-10)
    assert got.labels == want.labels

    # the eigenvectors of degenerate levels are not unique: the transition
    # dipoles are compared back in the basis of the manifolds' states
    def basis_dm(r):
        return np.einsum("ij,jlx,kl->ikx", r.vso, r.dmso, r.vso.conjugate())

    np.testing.assert_allclose(basis_dm(rg), basis_dm(rw), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(si.vso_to_hm(vso_mo), jax_si.vso_to_hm(vso_mo))


def test_o_atom_soc_si_matches_jax(o_mfs):
    """The slice as a whole on the O atom's 3P term, against the JAX
    pipeline on the same orbitals and the stored JAX golden."""
    jmf, mf = o_mfs
    want = jax_run_soc_si(jmf, nstates=8, cal_osc=True).result
    got_si = run_soc_si(mf, nstates=8, cal_osc=True)
    got = got_si.result
    assert np.abs(got.eso - want.eso).max() * CM < 0.01
    gold = json.loads((DATA / "golden_stability_soc.json").read_text())["o_socsi"]
    assert np.abs(got.eso - np.asarray(gold["eso"])).max() * CM < 0.01
    # tests/test_soc_si.py's physics gates
    e = (got.eso - got.eso[0]) * CM
    low = e[e < 5000]
    assert len(low) == 9
    j2, j1, j0 = low[:5], low[5:8], low[8]
    assert j2.max() - j2.min() < 25.0 and j1.max() - j1.min() < 25.0
    d21, d10 = j1.mean() - j2.mean(), j0 - j1.mean()
    assert d21 > 0 and d10 > 0 and d21 / d10 == pytest.approx(2.0, rel=0.35)
    assert 50.0 < j0 < 400.0
    assert np.abs(got.hso - got.hso.T.conjugate()).max() < 1e-12
    fs = [got_si.osc_strength(0, j) for j in range(1, min(12, got_si.dim))]
    assert all(f > -1e-10 for f in fs)
    assert set(got_si.legs) == {"reference", "xsf", "xtda", "sfup", "vso", "si"}


def test_fso_reader_and_space_dims(tmp_path):
    from xtddft_tpu.soc import interop as jax_interop
    from xtddft_tpu_torch.soc import interop

    mat = np.arange(2 * 3 * 3, dtype=float).reshape(2, 3, 3)
    for iop, data in ((0, mat), (1, np.moveaxis(mat, 0, -1))):
        p = tmp_path / f"fso{iop}.txt"
        p.write_text(f"iop={iop} ncomp=2 nbas=3\n"
                     + "\n".join(str(x) for x in data.reshape(-1, order="F")) + "\n")
        got, want = interop.read_fso_file(str(p)), jax_interop.read_fso_file(str(p))
        np.testing.assert_array_equal(got["matrix"], want["matrix"])
        np.testing.assert_array_equal(got["matrix"], mat)
    assert interop.space_dims(33, 59, 1.5) == jax_interop.space_dims(33, 59, 1.5)


def test_zeeman_matches_jax(o_mfs):
    from xtddft_tpu.soc import zeeman as jax_zeeman
    from xtddft_tpu_torch.soc import zeeman

    jmf, mf = o_mfs
    for got, want in zip(zeeman.get_zeeman(mf), jax_zeeman.get_zeeman(jmf)):
        _close(got, want, 1e-10)

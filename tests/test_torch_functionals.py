"""The port's meta-GGA (TPSS, TPSSh) against the JAX package's, f64, CPU.

(a) the functionals: ``eval_exc`` and the six channels of ``eval_vxc`` on the
    seeded points of tests/test_mgga.py (relative 1e-12);
(b) K2's tau row (``ncomp=5``) and K3's tau term (``dwt``): the plain
    versions against the JAX einsums (`sigma_df.py:505-507`, `:531-533`,
    `xc/interface.py:53`, `:112`), and the wrapper's A operands contracted
    as the kernel's three extra GEMMs and epilogues (relative 1e-12);
(c) one TPSSh Fock build, `SCF._veff_and_exc`, at the JAX SCF's density
    (1e-10 Ha), and the port's own ROKS/TPSSh SCF of OH/STO-3G, grid 1,
    against the JAX one (1e-8 Ha);
(d) on the JAX SCF carried into the port through the shared checkpoint
    format: each package's DF data (B, the MO table and the ground-state
    densities with tau, relative 1e-12); the DF X-TDA and XSF-TDA sigmas
    (method 1, the five-component multicollinear kernel) on the JAX DF data
    carried across; the roots of the dense and in-core drivers against the
    JAX dense drivers (1e-8 eV).  The flip sigmas on well-conditioned
    synthetic meta-GGA data are in tests/test_torch_flip.py.

TPSS amplifies rounding: near rho ~ 1e-11 the fully polarized PBE epsilon
inside `tpss_c` is eps + H with H ~ -eps (the large-gradient limit), a
1e-28 difference of 1e-15 terms, and its second derivatives elsewhere
carry a smaller gain.  A last-bit difference of the inputs (the port's
density on the grid sums in another order than the JAX einsum) becomes
4.6e-9 Ha in OH's dense A matrix, so the JAX dense drivers here see the
port's ground-state densities.  XLA's compiled X-TDA sigma (fused, with
its own contractions of multiply-adds) sits 2.7e-9 (relative to its
largest element) from the same JAX sigma run op by op under
``jax.disable_jit()``, which the port matches to 7e-15 (measured, 33 s of
eager JAX: not in the suite); the X-TDA case is held at 1e-8 for that.

One JAX SCF and one JAX DF build for the whole file; each multicollinear
kernel and the JAX dense X-TDA matrix are built once (``builds_once``).
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xtddft_tpu.chem import Molecule as JaxMolecule
from xtddft_tpu.methods import drivers as jax_drivers
from xtddft_tpu.response import dense as jax_dense
from xtddft_tpu.response import sigma_df as jax_sigma_df
from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf import ROKS as JaxROKS
from xtddft_tpu.scf.checkpoint import save_mf as jax_save_mf
from xtddft_tpu.xc import interface as jax_xci
from xtddft_tpu.xc import registry as jax_registry
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.kernels import grid_back as k3
from xtddft_tpu_torch.kernels import grid_rho1 as k2
from xtddft_tpu_torch.methods import drivers
from xtddft_tpu_torch.response import sigma_df
from xtddft_tpu_torch.response.sigma import _rho0
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf import ROKS
from xtddft_tpu_torch.scf.checkpoint import load_mf
from xtddft_tpu_torch.xc import interface as xci
from xtddft_tpu_torch.xc import registry


OH = "O 0 0 0; H 0 0 0.97"
RTOL = 1e-12
SIGMA_RTOL = 1e-10
# the X-TDA sigma's tau jvp: XLA's compiled evaluation against its op-by-op
# one, 2.7e-9 at OH/STO-3G (see the module docstring)
XTDA_JIT_RTOL = 1e-8
ROOTS_EV = 1e-8
NZ, GC, NMO = 3, 37, 40


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel_close(got, want, rtol):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# ---- (a) the functionals ----

def _mgga_points():
    """The seeded points of tests/test_mgga.py::test_tpss_vxc_matches_fd."""
    rng = np.random.default_rng(1)
    ng = 24
    ra = 10.0 ** rng.uniform(-3, 0.5, ng)
    rb = ra * rng.uniform(0.4, 1.0, ng)
    ga = 0.3 * rng.normal(size=(3, ng)) * ra
    gb = 0.3 * rng.normal(size=(3, ng)) * rb
    tw_a = np.einsum("xg,xg->g", ga, ga) / (8 * ra)
    tw_b = np.einsum("xg,xg->g", gb, gb) / (8 * rb)
    ta = tw_a * rng.uniform(1.5, 4.0, ng)
    tb = tw_b * rng.uniform(1.5, 4.0, ng)
    w = rng.uniform(0.5, 1.0, ng)
    return w, (ra, rb, ga, gb, ta, tb)


@pytest.mark.parametrize("name", ["tpss", "tpssh"])
def test_functional_channels(name):
    """Exc and the six weighted potential channels (rho, grad rho and tau of
    each spin)."""
    w, rho = _mgga_points()
    jspec, spec = jax_registry.resolve(name), registry.resolve(name)
    jrho = tuple(map(jnp.asarray, rho))
    trho = tuple(map(torch.as_tensor, rho))
    want = float(jax_xci.eval_exc(jspec, jnp.asarray(w), jrho))
    got = float(xci.eval_exc(spec, torch.as_tensor(w), trho))
    assert abs(got - want) <= RTOL * abs(want)
    jdv = jax_xci.eval_vxc(jspec, jnp.asarray(w), jrho)
    dv = xci.eval_vxc(spec, torch.as_tensor(w), trho)
    assert len(dv) == len(jdv) == 6
    for a, b in zip(dv, jdv):
        _rel_close(a, b, RTOL)


# ---- (b) K2's tau row and K3's tau term ----

def _jax_tau_row(phi, z, o0, v0, phi_v):
    """t = 1/2 sum_y sum_ov z p1_o p1_v, as `sigma_df.py:505-507` forms it."""
    nz, nocc, nvir = z.shape
    pv = phi if phi_v is None else phi_v
    tmp2 = jnp.einsum("xov,ygv->xygo", z, pv[1:4][:, :, v0:v0 + nvir])
    return 0.5 * jnp.einsum("xygo,ygo->xg", tmp2, phi[1:4][:, :, o0:o0 + nocc])


K2_CASES = {"xtda": (0, 11, 11, 23, False), "more_occupied": (0, 23, 23, 11, False),
            "overlap": (3, 11, 9, 23, False), "offsets_two_tables": (1, 20, 14, 9, True)}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_tau_row_plain_matches_jax(case):
    """K2's plain version with ``ncomp=5``: rows 0-3 are the ``ncomp=4``
    rows, row 4 the JAX tau einsum; masked rows are zero."""
    o0, nocc, v0, nvir, two = K2_CASES[case]
    rng = np.random.default_rng(20)
    z = rng.normal(size=(NZ, nocc, nvir))
    phi = rng.normal(size=(4, GC, NMO))
    phi_v = rng.normal(size=(4, GC, NMO)) if two else None
    mask = (rng.uniform(size=GC) > 0.2).astype(np.float64)
    tphi_v = None if phi_v is None else torch.as_tensor(phi_v)
    got = k2.grid_rho1_plain(torch.as_tensor(phi), torch.as_tensor(z), o0, v0,
                             torch.as_tensor(mask), tphi_v, ncomp=5)
    four = k2.grid_rho1_plain(torch.as_tensor(phi), torch.as_tensor(z), o0, v0,
                              torch.as_tensor(mask), tphi_v, ncomp=4)
    np.testing.assert_array_equal(_np(got[:, :4]), _np(four))
    want = _jax_tau_row(jnp.asarray(phi), jnp.asarray(z), o0, v0,
                        None if phi_v is None else jnp.asarray(phi_v)) * mask
    _rel_close(got[:, 4], want, RTOL)


def test_tau_row_hermitian_matches_jax_cache_rho():
    """K2's hermitian mode with the tau row (`cache_rho(tau=True)`) on a
    symmetric and on a non-symmetric stack, against the JAX `cache_rho`."""
    rng = np.random.default_rng(21)
    nao = 9
    ao = rng.normal(size=(4, GC, nao))
    c = rng.normal(size=(nao, 4))
    for dm, hermi in ((c @ c.T, True), (rng.normal(size=(nao, nao)), False)):
        want = jax_xci.cache_rho(jnp.asarray(ao), jnp.asarray(dm), hermi=hermi, tau=True)
        got = xci.cache_rho(torch.as_tensor(ao), torch.as_tensor(dm), hermi=hermi, tau=True)
        assert len(got) == 3
        for a, b in zip(got, want):
            _rel_close(a, b, RTOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_tau_row_operands_give_plain(case, dtype):
    """The tau row as the kernel forms it from the wrapper's A operand of
    tmp (`csrc/grid_rho1.cu`): tmp_y = za^T pv_y over k, its rows (x, i)
    against po_y[:, o0 - so + i], times 1/2, summed over y: the layout
    contract of the three extra GEMMs."""
    o0, nocc, v0, nvir, two = K2_CASES[case]
    rng = np.random.default_rng(22)
    z = torch.as_tensor(rng.normal(size=(NZ, nocc, nvir))).to(dtype).double()
    phi = torch.as_tensor(rng.normal(size=(4, GC, NMO)))
    phi_v = torch.as_tensor(rng.normal(size=(4, GC, NMO))) if two else None
    pv = phi if phi_v is None else phi_v
    so, sv, za, ra, zb, rb, vu = k2.operands(z.to(dtype), o0, v0, 5)
    assert za is not None and zb is not None
    a = za.double()[:, :, :so + nocc]
    t = sum(torch.einsum("xig,gi->xg",
                         torch.einsum("kxi,gk->xig", a, pv[y][:, v0 - sv:v0 + nvir]),
                         phi[y][:, o0 - so:o0 + nocc]) for y in (1, 2, 3))
    want = k2.grid_rho1_plain(phi, z, o0, v0, None, phi_v, 5)[:, 4]
    _rel_close(0.5 * t, want, RTOL)


@pytest.mark.parametrize("case", list(K2_CASES))
def test_tau_term_plain_matches_jax(case):
    """K3's plain version with ``dwt``: the ``dwg`` back-projection plus the
    JAX tau einsum `sigma_df.py:531-533`."""
    o0, nocc, v0, nvir, two = K2_CASES[case]
    rng = np.random.default_rng(23)
    phi = rng.normal(size=(4, GC, NMO))
    phi_v = rng.normal(size=(4, GC, NMO)) if two else None
    dwv, dwg, dwt = (rng.normal(size=(NZ, GC)), rng.normal(size=(NZ, 3, GC)),
                     rng.normal(size=(NZ, GC)))
    tphi_v = None if phi_v is None else torch.as_tensor(phi_v)
    out = torch.zeros((NZ, nocc, nvir), dtype=torch.float64)
    k3.grid_back_plain(torch.as_tensor(dwv), torch.as_tensor(dwg), torch.as_tensor(phi), o0, v0,
                       out, tphi_v, dwt=torch.as_tensor(dwt))
    base = torch.zeros_like(out)
    k3.grid_back_plain(torch.as_tensor(dwv), torch.as_tensor(dwg), torch.as_tensor(phi), o0, v0,
                       base, tphi_v)
    pv = phi if phi_v is None else phi_v
    want = 0.5 * np.asarray(jnp.einsum("xg,ygo,ygv->xov", dwt, phi[1:4][:, :, o0:o0 + nocc],
                                       pv[1:4][:, :, v0:v0 + nvir]))
    _rel_close(out - base, want, RTOL)
    # the wrapper sends a CPU tensor to the plain version, and refuses a tau
    # term without a gradient term
    again = torch.zeros_like(out)
    k3.grid_back(torch.as_tensor(dwv), torch.as_tensor(dwg), torch.as_tensor(phi), o0, v0, again,
                 tphi_v, dwt=torch.as_tensor(dwt))
    np.testing.assert_array_equal(_np(again), _np(out))
    with pytest.raises(ValueError, match="tau term"):
        k3.grid_back(torch.as_tensor(dwv), None, torch.as_tensor(phi), o0, v0, again,
                     dwt=torch.as_tensor(dwt))


def test_tau_term_ao_matches_jax_contract_vmat():
    """K3 on the AO table with the tau term: `_contract_vmat(wtau=...)`, for
    one matrix and for a stack of two."""
    rng = np.random.default_rng(24)
    nao = 9
    ao = rng.normal(size=(4, GC, nao))
    wv, wvec, wtau = rng.normal(size=(2, GC)), rng.normal(size=(2, 3, GC)), rng.normal(size=(2, GC))
    want = [np.asarray(jax_xci._contract_vmat(jnp.asarray(ao), jnp.asarray(wv[i]),
                                              jnp.asarray(wvec[i]), jnp.asarray(wtau[i])))
            for i in range(2)]
    got = xci._contract_vmat(torch.as_tensor(ao), torch.as_tensor(wv), torch.as_tensor(wvec),
                             torch.as_tensor(wtau))
    _rel_close(got, np.stack(want), RTOL)
    one = xci._contract_vmat(torch.as_tensor(ao), torch.as_tensor(wv[0]),
                             torch.as_tensor(wvec[0]), torch.as_tensor(wtau[0]))
    _rel_close(one, want[0], RTOL)


# ---- (c), (d) OH/STO-3G ROKS/TPSSh ----

def _bytes_key(*arrays):
    return tuple(hashlib.sha1(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()
                 for a in arrays)


@pytest.fixture(scope="module", autouse=True)
def builds_once():
    """The expensive builds are made once for the file: the JAX
    multicollinear kernel of one grid and density (the two dense flip
    drivers share it), the port's of the same inputs (its dense and in-core
    flip drivers share it; keyed by the bytes of its inputs), and the JAX
    dense X-TDA matrix of one Reference (the dense and in-core root cases
    are both held to it)."""
    from xtddft_tpu.xc import mcol as jax_mcol
    from xtddft_tpu_torch.xc import mcol

    real_jax, real_port, real_xtda = (jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol,
                                      jax_dense.xtda_dense)
    cache = {}

    def once(key, make):
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def jax_kernel(spec, weights, rho0, nt=20):
        return once(("jax", spec.name, nt) + _bytes_key(weights, *rho0),
                    lambda: real_jax(spec, weights, rho0, nt))

    def port_kernel(spec, weights, rho0, nt=20):
        return once(("port", mcol.MCOL_POINTS, spec.name, nt) + _bytes_key(weights, *rho0),
                    lambda: real_port(spec, weights, rho0, nt))

    def jax_xtda(ref, spin_adapt=True):
        return once(("xtda", id(ref), spin_adapt), lambda: real_xtda(ref, spin_adapt))

    jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol = jax_kernel, port_kernel
    jax_dense.xtda_dense = jax_xtda
    yield
    jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol = real_jax, real_port
    jax_dense.xtda_dense = real_xtda


@pytest.fixture(scope="module")
def oh_tpssh(tmp_path_factory):
    """(the JAX SCF, its Reference, the port's mean field and Reference on
    the same orbitals): one JAX SCF, carried across by checkpoint."""
    jmf = JaxROKS(JaxMolecule.from_atoms(OH, basis="sto-3g", spin=1), xc="tpssh",
                  grid_level=1).kernel()
    assert jmf.converged
    path = str(tmp_path_factory.mktemp("tpssh") / "oh.npz")
    jax_save_mf(jmf, path)
    mf = load_mf(path, device="cpu")
    return jmf, jax_make_reference(jmf), mf, make_reference(mf)


def test_veff_and_exc_matches_jax(oh_tpssh):
    """One TPSSh Fock build at the JAX SCF's density: the potentials (K2 with
    its tau row, K3 with its tau term, in their fixed order) and the
    two-electron energy."""
    jmf, _, mf, _ = oh_tpssh
    da, db = (np.asarray(d) for d in jmf.make_rdm1())
    want = JaxROKS(JaxMolecule.from_atoms(OH, basis="sto-3g", spin=1), xc="tpssh",
                   env=jmf.env)._veff_and_exc(da, db)
    got = ROKS(mf.env.mol, xc="tpssh", env=mf.env)._veff_and_exc(da, db)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-10)
    assert abs(got[2] - want[2]) < 1e-10


def test_scf_matches_jax(oh_tpssh):
    """The port's own ROKS/TPSSh SCF, from its own guess, lands on the JAX
    package's energy."""
    jmf = oh_tpssh[0]
    mf = ROKS(Molecule.from_atoms(OH, basis="sto-3g", spin=1), xc="tpssh", grid_level=1,
              device="cpu").kernel()
    assert mf.converged
    assert abs(mf.e_tot - jmf.e_tot) < 1e-8


def _carry(jdata):
    """A JAX DFData as the port's, through host arrays."""
    fields = {f: getattr(jdata, f) for f in ("nc", "no", "nv", "B", "fock_mo", "hyb", "phi",
                                             "grid_w", "fock_hf_mo", "B_lr", "hyb_lr")}
    fields["rho0"] = [np.asarray(r) for r in jdata.rho0]
    return sigma_df.df_data_from_arrays(fields, jdata.spec.name, device="cpu",
                                        dtype=torch.float64)


@pytest.fixture(scope="module")
def oh_df(oh_tpssh):
    """(JAX DFData, the port's own DFData, the JAX one carried across) of the
    same orbitals: one JAX DF build."""
    _, jref, _, ref = oh_tpssh
    jdata = jax_sigma_df.build_df_data(jref)
    data = sigma_df.build_df_data(ref)
    assert len(jdata.rho0) == len(data.rho0) == 6
    return jdata, data, _carry(jdata)


def _check_op(jop, op, seed, rtol):
    assert op.dim == jop.dim
    z = np.random.default_rng(seed).normal(size=(3, op.dim))
    _rel_close(op.matvec(torch.as_tensor(z)), jop.matvec(z), rtol)
    _rel_close(op.hdiag, jop.hdiag, SIGMA_RTOL)


DF_OPS = {
    "xtda": (lambda m, d: m.xtda_sigma_df(d), XTDA_JIT_RTOL),
    "xsf_mcol": (lambda m, d: m.xsf_sigma_df(d, SA=0, method=1, remove=False), SIGMA_RTOL),
}


@pytest.mark.parametrize("name", list(DF_OPS))
def test_df_sigma_matches_jax(oh_df, name):
    """The DF sigmas with the tau channel (K2's tau row and K3's tau term,
    the five-component multicollinear kernel) on the same DF data."""
    jdata, _, carried = oh_df
    make, rtol = DF_OPS[name]
    _check_op(make(jax_sigma_df, jdata), make(sigma_df, carried), 30, rtol)


def test_df_data_carries_tau(oh_df):
    """The port's own DF data (B, the MO table, the grid densities with the
    tau pair from K2's hermitian row) is the JAX package's, and tau survives
    `cast_df_data` with the benign tau = 1 on floored points."""
    jdata, data, _ = oh_df
    for a, b in zip((data.B, data.phi) + data.rho0, (jdata.B, jdata.phi) + jdata.rho0):
        _rel_close(a, b, RTOL)
    cast = sigma_df.cast_df_data(data, torch.float32)
    jcast = jax_sigma_df.cast_df_data(jdata, np.float32)
    assert len(cast.rho0) == 6
    for a, b in zip(cast.rho0[4:], jcast.rho0[4:]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


_RHO0 = {}


def _port_rho0(ref):
    """The port's ground-state densities as JAX arrays, one tuple object per
    Reference (the JAX kernel cache keys on it)."""
    if id(ref) not in _RHO0:
        _RHO0[id(ref)] = tuple(jnp.asarray(_np(r)) for r in _rho0(ref))
    return _RHO0[id(ref)]


ROOT_CASES = {
    "xtda_dense": (lambda m, r: m.XTDA(r, nstates=4, backend="dense"),
                   lambda m, r: m.XTDA(r, nstates=4, backend="dense")),
    "xtda_incore": (lambda m, r: m.XTDA(r, nstates=4, backend="incore"),
                    lambda m, r: m.XTDA(r, nstates=4, backend="dense")),
    "xsf_mcol_dense": (lambda m, r: m.XSFTDA(r, nstates=4, SA=0, method=1, backend="dense"),
                       lambda m, r: m.XSFTDA(r, nstates=4, SA=0, method=1, backend="dense")),
    "sf_down_mcol_incore": (
        lambda m, r: m.SFTDA(r, nstates=4, extype="down", method=1, backend="incore"),
        lambda m, r: m.SFTDA(r, nstates=4, extype="down", method=1, backend="dense")),
}


@pytest.mark.parametrize("case", list(ROOT_CASES))
def test_roots_match_jax(oh_tpssh, case, monkeypatch):
    """The dense and in-core drivers on the carried reference against the
    JAX dense drivers, which see the port's ground-state densities (the
    in-core Davidson converges the roots to its tolerance)."""
    _, jref, _, ref = oh_tpssh
    rho0 = _port_rho0(ref)
    monkeypatch.setattr(jax_dense, "_rho0", lambda _ref: rho0)
    make, make_jax = ROOT_CASES[case]
    got = make(drivers, ref).kernel()
    want = make_jax(jax_drivers, jref).kernel()
    assert got.converged
    n = min(len(got.e), len(want.e))
    np.testing.assert_allclose(got.e_eV[:n], want.e_eV[:n], rtol=0, atol=ROOTS_EV)


def test_alda0_refuses_mgga(oh_tpssh):
    """The ALDA0 spin-flip kernel is not defined for a meta-GGA, in the port
    as in the JAX package."""
    ref = oh_tpssh[3]
    with pytest.raises(NotImplementedError, match="MGGA"):
        drivers.SFTDA(ref, nstates=2, method=0, backend="dense").kernel()
    with pytest.raises(NotImplementedError, match="MGGA"):
        xci.sf_kernel_alda0(registry.resolve("tpssh"), ref.env.grid_weights, _rho0(ref))

"""The port's dense backend and its drivers against the JAX package's, f64, CPU.

Each dense builder of `response/dense.py` against its JAX twin on the same
reference, elementwise; then every driver and backend of
`methods/drivers.py` (TDA, UTDA, and XTDA, SFTDA, XSFTDA on their 'dense'
and 'incore' backends) against the JAX package's roots, oscillator and
rotatory strengths and <dS^2>; and the canonical flow of the package's
documents, ``ROKS(OH/STO-3G)`` -> ``XTDA`` with no backend named.

References, all FH/6-31G/BHandHLYP at grid 1 (one grid, so that the JAX
package compiles its per-point Hessian once): the triplet ROKS (the JAX
session fixture ``fh_roks``, carried into the port), and two port SCFs
carried into the JAX package through the shared checkpoint format, the
singlet RKS (closed shell) and the triplet UKS; the JAX side builds its
Reference on each with its own ``make_reference``.  The JAX roots are those
of its dense drivers, which the in-core backend matches to the Davidson's
tolerance.
"""

import hashlib

import numpy as np
import pytest
import torch

from xtddft_tpu.methods import drivers as jax_drivers
from xtddft_tpu.response import dense as jax_dense
from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu.scf.checkpoint import save_mf as jax_save_mf
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.methods import drivers
from xtddft_tpu_torch.response import dense
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf import RKS, ROKS, UKS
from xtddft_tpu_torch.scf.checkpoint import load_mf, save_mf


FH = "F 0 0 0; H 0 0 1.0"
OH = "O 0 0 0; H 0 0 0.97"
ROOTS_EV = 1e-6
PROPS = 1e-6


@pytest.fixture(scope="module", autouse=True)
def mcol_kernels_once():
    """Each package's multicollinear kernel of one grid and density is
    computed once for the file (the up and down flip builders share it),
    keyed by the bytes of its weights and densities and the port's batch
    size."""
    from xtddft_tpu.xc import mcol as jax_mcol
    from xtddft_tpu_torch.xc import mcol

    real_jax, real_port, cache = jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol, {}

    def once(real, tag):
        def cached(spec, weights, rho0, nt=20):
            key = (tag, mcol.MCOL_POINTS, spec.name, nt) + tuple(
                hashlib.sha1(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()
                for a in (weights, *rho0))
            if key not in cache:
                cache[key] = real(spec, weights, rho0, nt)
            return cache[key]
        return cached

    jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol = once(real_jax, "jax"), once(real_port, "port")
    yield
    jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol = real_jax, real_port


@pytest.fixture(scope="module")
def refs(fh_roks, tmp_path_factory):
    """{name: (JAX Reference, port Reference)} for the FH ROKS triplet, the
    FH RKS singlet ("rks") and the FH UKS triplet ("uks")."""
    tmp = tmp_path_factory.mktemp("dense")
    jax_save_mf(fh_roks, str(tmp / "fh.npz"))
    out = {"fh": (jax_make_reference(fh_roks),
                  make_reference(load_mf(str(tmp / "fh.npz"), device="cpu")))}
    for name, mf in (
            ("rks", RKS(Molecule.from_atoms(FH, basis="6-31g"), xc="bhandhlyp", grid_level=1,
                        device="cpu").kernel()),
            ("uks", UKS(Molecule.from_atoms(FH, basis="6-31g", spin=2), xc="bhandhlyp",
                        grid_level=1, device="cpu").kernel())):
        assert mf.converged
        save_mf(mf, str(tmp / f"{name}.npz"))
        out[name] = (jax_make_reference(jax_load_mf(str(tmp / f"{name}.npz"))),
                     make_reference(mf))
    return out


BUILDERS = {
    "tda_singlet": ("rks", lambda m, r: m.tda_singlet_dense(r)),
    "tda_triplet": ("rks", lambda m, r: m.tda_triplet_dense(r)),
    "utda": ("uks", lambda m, r: m.utda_dense(r)),
    "xtda": ("fh", lambda m, r: m.xtda_dense(r)),
    "sf_up_alda0": ("fh", lambda m, r: m.sf_up_dense(r, 0)),
    "sf_down_alda0": ("fh", lambda m, r: m.sf_down_dense(r, 0)),
    "sf_up_mcol": ("fh", lambda m, r: m.sf_up_dense(r, 1)),
    "sf_down_mcol": ("fh", lambda m, r: m.sf_down_dense(r, 1)),
    "xsf_sa0": ("fh", lambda m, r: m.xsf_dense(r, SA=0, remove=False)[0]),
    "xsf_sa3": ("fh", lambda m, r: m.xsf_dense(r, SA=3, fglobal=0.65)[0]),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder(refs, name):
    """Each dense matrix, elementwise against the JAX builder."""
    which, build = BUILDERS[name]
    jref, ref = refs[which]
    want = np.asarray(build(jax_dense, jref))
    got = build(dense, ref)
    assert got.device == ref.env.device and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


DRIVERS = {
    "tda_singlet": ("rks", "TDA", {"nstates": 5}),
    "tda_triplet": ("rks", "TDA", {"nstates": 5, "singlet": False}),
    "utda": ("uks", "UTDA", {"nstates": 5}),
    "xtda_dense": ("fh", "XTDA", {"nstates": 5, "backend": "dense"}),
    "xtda_incore": ("fh", "XTDA", {"nstates": 5, "backend": "incore"}),
    "sftda_up_dense": ("fh", "SFTDA", {"nstates": 4, "extype": "up", "backend": "dense"}),
    "sftda_up_incore": ("fh", "SFTDA", {"nstates": 4, "extype": "up", "backend": "incore"}),
    "sftda_down_dense": ("fh", "SFTDA", {"nstates": 4, "extype": "down", "backend": "dense"}),
    "sftda_down_incore": ("fh", "SFTDA", {"nstates": 4, "extype": "down",
                                          "backend": "incore"}),
    "xsftda_dense": ("fh", "XSFTDA", {"nstates": 4, "backend": "dense"}),
    "xsftda_incore": ("fh", "XSFTDA", {"nstates": 4, "use_davidson": True}),
    "xsftda_sa0_dense": ("fh", "XSFTDA", {"nstates": 4, "SA": 0, "backend": "dense"}),
}


def _jax_result(refs, which, cls, kw):
    """The JAX driver's result on its dense backend (cached per case)."""
    key = (which, cls, tuple(sorted((k, v) for k, v in kw.items()
                                    if k not in ("backend", "use_davidson"))))
    cache = refs.setdefault("_jax", {})
    if key not in cache:
        kw = {k: v for k, v in kw.items() if k not in ("backend", "use_davidson")}
        if cls not in ("TDA", "UTDA"):
            kw["backend"] = "dense"
        cache[key] = getattr(jax_drivers, cls)(refs[which][0], **kw).kernel()
    return cache[key]


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver(refs, name):
    """Roots, oscillator and rotatory strengths and <dS^2> of every driver
    and backend against the JAX package's."""
    which, cls, kw = DRIVERS[name]
    got = getattr(drivers, cls)(refs[which][1], **kw).kernel()
    want = _jax_result(refs, which, cls, kw)
    backend = kw.get("backend", "incore" if kw.get("use_davidson") else "dense")
    assert got.solver == backend and got.converged
    np.testing.assert_allclose(got.e_eV, np.asarray(want.e_eV), rtol=0, atol=ROOTS_EV)
    for prop in ("osc", "rot", "ds2"):
        w, g = getattr(want, prop), getattr(got, prop)
        assert (w is None) == (g is None), prop
        if w is None:
            continue
        np.testing.assert_allclose(np.abs(g), np.abs(np.asarray(w)), rtol=0, atol=PROPS)


def test_incore_operator_mcol(refs):
    """The in-core SF-down operator with the multicollinear kernel (here, as
    the dense builders above compute the same kernel in both packages)."""
    from test_torch_incore import check_operator
    from xtddft_tpu.response import sigma as jax_sigma
    from xtddft_tpu_torch.response import sigma

    jref, ref = refs["fh"]
    check_operator(jax_sigma.sf_sigma_operator(jref, "down", 1),
                   sigma.sf_sigma_operator(ref, "down", 1), 12)


def test_canonical_flow(tmp_path):
    """``ROKS(OH/STO-3G)`` -> ``XTDA(mf, nstates=5)`` with no ``df`` and no
    backend: the in-core SCF and the dense route, held to the JAX package's
    roots on the port's mean field (its in-core backend: the same matrix)."""
    mf = ROKS(Molecule.from_atoms(OH, basis="sto-3g", spin=1), xc="b3lyp", grid_level=1,
              device="cpu").kernel()
    assert not mf.env.df and mf.converged
    got = drivers.XTDA(mf, nstates=5).kernel()
    assert got.solver == "dense"
    save_mf(mf, str(tmp_path / "oh.npz"))
    want = jax_drivers.XTDA(jax_load_mf(str(tmp_path / "oh.npz")), nstates=5,
                            backend="incore").kernel()
    np.testing.assert_allclose(got.e_eV, np.asarray(want.e_eV), rtol=0, atol=ROOTS_EV)
    np.testing.assert_allclose(got.osc, np.asarray(want.osc), rtol=0, atol=PROPS)
    np.testing.assert_allclose(got.ds2, np.asarray(want.ds2), rtol=0, atol=PROPS)


@pytest.mark.parametrize("name", ["xtda_dense", "xsftda_dense"])
def test_state_irreps(refs, name):
    """``symmetry=True`` labels each FH triplet state as the JAX package's
    `props/irreps.state_irreps` labels its driver's vectors."""
    from xtddft_tpu.props.irreps import state_irreps as jax_state_irreps

    which, cls, kw = DRIVERS[name]
    got = getattr(drivers, cls)(refs[which][1], symmetry=True, **kw).kernel()
    want = _jax_result(refs, which, cls, kw)
    kind = "spin_conserving" if cls == "XTDA" else "spin_flip"
    assert len(got.irreps) == kw["nstates"]
    assert got.irreps == jax_state_irreps(refs[which][0], np.asarray(want.v), kind=kind)[0]


def test_state_irreps_closed_shell(refs):
    """`props/irreps.state_irreps` on the FH singlet's TDA vectors, laid out
    as CV(a)|CV(b), against the JAX function on the same vectors."""
    from xtddft_tpu.props.irreps import state_irreps as jax_state_irreps
    from xtddft_tpu_torch.props.irreps import state_irreps

    jref, ref = refs["rks"]
    v = drivers.TDA(ref, nstates=8).kernel().v / np.sqrt(2.0)
    v = np.concatenate([v, v])
    got = state_irreps(ref, v)
    assert got == jax_state_irreps(jref, v)
    assert got[1] == "C2v" and set(got[0]) - {"?"}


def test_so2st_out(refs):
    """``so2st_out`` returns the X-TDA vectors in the spin-tensor basis."""
    from xtddft_tpu.response.spaces import so2st as jax_so2st

    which, cls, kw = DRIVERS["xtda_dense"]
    jref, ref = refs[which]
    got = drivers.XTDA(ref, so2st_out=True, **kw).kernel()
    want = jax_so2st(np.asarray(_jax_result(refs, which, cls, kw).v), jref.nc, jref.no, jref.nv)
    np.testing.assert_allclose(np.abs(got.v), np.abs(want), rtol=0, atol=1e-8)

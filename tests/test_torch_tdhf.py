"""The port's full TDHF/RPA slice against the JAX package, f64 on the CPU.

- K1's RPA exchange, plain version, in both contraction orders and chunked,
  against the JAX ``_k2`` (read off the JAX paired operator: its B half at
  hyb = 1 less that at hyb = 0), relative 1e-12;
- the paired DF operator ``xtda_sigma_df(with_b=True)`` against the JAX one
  on the same DF data (FH's, carried across; and with a synthetic B_lr),
  relative 1e-10, whose A half is bitwise the ``with_b=False`` matvec;
- the dense (A, B) builders elementwise (1e-10 Ha) and ``solve_casida``'s
  roots (1e-8 eV) on FH RHF, UHF and ROKS;
- ``RPAInstabilityError`` on stretched H2, dense and DF;
- the DF drivers (``TDHF`` singlet and triplet, ``UTDHF``, ``XTDHF``) on
  DF-SCF references, held to the Casida roots of the operator's own pencil
  (1e-8 eV) and to the JAX package's dense Casida (5e-3 eV, the fit
  error), and the dense drivers' roots (1e-8 eV) and strengths (1e-6)
  against the JAX dense drivers.

References: FH/6-31G converged through the DF SCF: the JAX session fixture
``fh_roks_df`` (the BHandHLYP triplet ROKS at grid 1, whose fxc term enters B)
carried into the port, and the port's RHF singlet and UHF triplet carried
into the JAX package through the shared checkpoint format (Hartree-Fock: no
grid, which keeps the file's own pencils and solves cheap).  The JAX DF
driver itself is not a reference: its default solver returns roots that are
not the operator's on these cases (ROADMAP fault 3.3,
`tools/jax_tdhf_fault.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from xtddft_tpu.methods import drivers as jax_drivers
from xtddft_tpu.response import sigma_df as jax_sigma_df
from xtddft_tpu.response import tdhf as jax_tdhf
from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu.scf.checkpoint import save_mf as jax_save_mf
from xtddft_tpu_torch import units
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.kernels import df_exchange as k1
from xtddft_tpu_torch.methods import drivers
from xtddft_tpu_torch.response import sigma_df, tdhf
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf import RHF, UHF
from xtddft_tpu_torch.scf.checkpoint import load_mf, save_mf


FH = "F 0 0 0; H 0 0 1.0"
PENCIL_EV = 1e-8
FIT_EV = 5e-3  # DF against exact ERIs (the JAX DF tests' gate)


def _rel_close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * np.abs(want).max())


def _carry(jdata, **replace):
    """A JAX DFData as the port's, through ``df_data_from_arrays``."""
    jdata = dataclasses.replace(jdata, **replace)
    fields = {f.name: getattr(jdata, f.name) for f in dataclasses.fields(jdata)}
    fields["rho0"] = [np.asarray(r) for r in jdata.rho0] if jdata.rho0 is not None else None
    for k, v in fields.items():
        if hasattr(v, "shape") and k not in ("fock_mo", "fock_hf_mo"):
            fields[k] = np.asarray(v)
    return jdata, sigma_df.df_data_from_arrays(fields, jdata.spec.name if jdata.spec else None,
                                               device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module", autouse=True)
def jax_xtdhf_pencil_once():
    """The JAX dense X-TDHF pencil of one mean field is built once for the
    file: the pencil test and the JAX dense driver of the DF-driver test
    share it (each build evaluates the fxc tensor on the grid)."""
    real, cache = jax_tdhf.xtdhf_dense, {}

    def cached(ref):
        if id(ref.mf) not in cache:
            cache[id(ref.mf)] = real(ref)
        return cache[id(ref.mf)]

    jax_tdhf.xtdhf_dense = cached
    yield
    jax_tdhf.xtdhf_dense = real


@pytest.fixture(scope="module")
def mfs(fh_roks_df, tmp_path_factory):
    """{name: (JAX MeanField, port MeanField)}, all converged through the DF SCF."""
    tmp = tmp_path_factory.mktemp("tdhf")
    jax_save_mf(fh_roks_df, str(tmp / "roks.npz"))
    out = {"roks": (fh_roks_df, load_mf(str(tmp / "roks.npz"), df=True, device="cpu"))}
    for name, cls, spin in (("rhf", RHF, 0), ("uhf", UHF, 2)):
        mf = cls(Molecule.from_atoms(FH, basis="6-31g", spin=spin), df=True,
                 device="cpu").kernel()
        assert mf.converged
        save_mf(mf, str(tmp / f"{name}.npz"))
        out[name] = (jax_load_mf(str(tmp / f"{name}.npz"), df=True), mf)
    return out


@pytest.fixture(scope="module")
def refs(mfs):
    return {k: (jax_make_reference(j), make_reference(p)) for k, (j, p) in mfs.items()}


@pytest.mark.parametrize("chunk", [None, 7], ids=["default_chunk", "chunk7"])
def test_rpa_exchange_plain_is_jax_k2(chunk):
    """Both orders: the alpha block (14 x 10) takes the JAX order, the beta
    block (8 x 16) the other; the aux chunk of 7 does not divide naux."""
    jdata = jax_sigma_df.synthetic_df_data(nmo=24, nc=8, no=6, naux=40, ngrid=256,
                                           dtype=np.float64)
    rng = np.random.default_rng(5)
    nocca, nvira, noccb, nvirb = 14, 10, 8, 16
    z = rng.normal(size=(3, nocca * nvira + noccb * nvirb))
    b1, b0 = (np.asarray(jax_sigma_df.xtda_sigma_df(
        dataclasses.replace(jdata, hyb=h), with_b=True).matvec(z))[1] for h in (1.0, 0.0))
    want = b0 - b1  # hyb * _k2, both spins
    B = torch.as_tensor(np.asarray(jdata.B))
    zt = torch.as_tensor(z)
    za = zt[:, :nocca * nvira].reshape(3, nocca, nvira)
    zb = zt[:, nocca * nvira:].reshape(3, noccb, nvirb)
    assert k1.rpa_order(nocca, nvira) == k1.RPA_VO and k1.rpa_order(noccb, nvirb) == k1.RPA_OV
    got_a = k1.rpa_exchange(B, za, 0, nocca, chunk)
    got_b = k1.rpa_exchange(B, zb, 0, noccb, chunk)
    _rel_close(got_a.reshape(3, -1), want[:, :nocca * nvira], 1e-12)
    _rel_close(got_b.reshape(3, -1), want[:, nocca * nvira:], 1e-12)
    torch.testing.assert_close(got_a, k1.rpa_exchange_plain(B, za, 0, nocca, chunk), rtol=0,
                               atol=0)
    # the same on the aligned copies the paired sigma makes once per operator
    for zs, no, lo, hi in ((za, nocca, 0, nocca * nvira), (zb, noccb, nocca * nvira, None)):
        got = k1.rpa_exchange(B, zs, 0, no, chunk, aligned=k1.rpa_aligned(B, 0, no, no,
                                                                          zs.shape[2]))
        _rel_close(got.reshape(3, -1), want[:, lo:hi], 1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_rpa_aligned_copy_is_the_block(dtype):
    """The aligned copy equals the strided ov block (RPA_OV) or its
    transpose (RPA_VO), with rows padded to 16 bytes by zeros; a copy of
    another block is refused."""
    rng = np.random.default_rng(6)
    B = torch.as_tensor(rng.normal(size=(5, 30, 30)), dtype=dtype)
    for o0, nocc, v0, nvir in ((0, 7, 7, 23), (0, 23, 23, 7), (2, 9, 13, 15), (0, 15, 15, 15)):
        R = k1.rpa_aligned(B, o0, nocc, v0, nvir)
        blk = B[:, o0:o0 + nocc, v0:v0 + nvir]
        want = blk if k1.rpa_order(nocc, nvir) == k1.RPA_OV else blk.transpose(1, 2)
        n2 = want.shape[2]
        assert R.is_contiguous() and R.shape[:2] == want.shape[:2]
        assert R.shape[2] * R.element_size() % 16 == 0 and 0 <= R.shape[2] - n2 < 16
        assert torch.equal(R[:, :, :n2], want)
        assert not R[:, :, n2:].any()
        z = torch.as_tensor(rng.normal(size=(2, nocc, nvir)), dtype=dtype)
        torch.testing.assert_close(k1.rpa_exchange_plain(B, z, o0, v0, aligned=R),
                                   k1.rpa_exchange_plain(B, z, o0, v0),
                                   rtol=1e-5 if dtype == torch.float32 else 1e-13,
                                   atol=1e-5 if dtype == torch.float32 else 1e-13)
        with pytest.raises(ValueError):
            k1.rpa_exchange_plain(B, z[:, :-4], o0, v0, aligned=R)


@pytest.fixture(scope="module")
def fh_df_data(refs):
    """FH ROKS's DF data built once by the JAX package."""
    return jax_sigma_df.build_df_data(refs["roks"][0])


@pytest.mark.parametrize("lr", [False, True], ids=["fh", "fh_synthetic_lr"])
def test_with_b_matvec(fh_df_data, lr):
    jdata = fh_df_data
    extra = {}
    if lr:
        rng = np.random.default_rng(9)
        noise = rng.normal(size=jdata.B.shape) * 1e-3
        extra = {"B_lr": 0.6 * np.asarray(jdata.B) + noise + noise.transpose(0, 2, 1),
                 "hyb_lr": 0.35}
    jdata, data = _carry(jdata, **extra)
    jop = jax_sigma_df.xtda_sigma_df(jdata, spin_adapt=True, with_b=True)
    op = sigma_df.xtda_sigma_df(data, spin_adapt=True, with_b=True)
    z = np.random.default_rng(2).normal(size=(4, op.dim))
    want = np.asarray(jop.matvec(z))
    got = op.matvec(torch.as_tensor(z))
    assert got.shape == (2, 4, op.dim)
    _rel_close(got[0].numpy(), want[0], 1e-10)
    _rel_close(got[1].numpy(), want[1], 1e-10)
    a_only = sigma_df.xtda_sigma_df(data, spin_adapt=True).matvec(torch.as_tensor(z))
    assert torch.equal(got[0], a_only)


PENCILS = {
    "rtdhf_singlet": ("rhf", lambda m, r: m.rtdhf_dense(r, True)),
    "rtdhf_triplet": ("rhf", lambda m, r: m.rtdhf_dense(r, False)),
    "utdhf": ("uhf", lambda m, r: m.utdhf_dense(r)),
    "xtdhf": ("roks", lambda m, r: m.xtdhf_dense(r)),
}


@pytest.mark.parametrize("name", list(PENCILS))
def test_dense_pencil(refs, name):
    which, build = PENCILS[name]
    jref, ref = refs[which]
    jA, jB = (np.asarray(m) for m in build(jax_tdhf, jref))
    A, B = build(tdhf, ref)
    assert A.dtype == B.dtype == torch.float64
    np.testing.assert_allclose(A.numpy(), jA, rtol=0, atol=1e-10)
    np.testing.assert_allclose(B.numpy(), jB, rtol=0, atol=1e-10)
    w = tdhf.solve_casida(A, B, 6)[0]
    jw = jax_tdhf.solve_casida(jA, jB, 6)[0]
    np.testing.assert_allclose(w * units.HA2EV, jw * units.HA2EV, rtol=0, atol=PENCIL_EV)


@pytest.mark.parametrize("backend", ["dense", "df"])
def test_instability_raises(backend):
    """Stretched H2 (STO-3G, 3.5 bohr): A - B of the triplet channel is not
    positive definite; the DF route raises from its stability re-check."""
    mol = Molecule.from_atoms("H 0 0 0; H 0 0 3.5", basis="sto-3g", unit="bohr")
    mf = RHF(mol, df=backend == "df", device="cpu").kernel()
    with pytest.raises(tdhf.RPAInstabilityError):
        drivers.TDHF(mf, nstates=2, singlet=False, backend=backend).kernel()


@pytest.fixture(scope="module")
def own_pencil(refs):
    """(reference, spin_adapt) -> the DF operator's own (A, B), by applying
    it to the identity, built once."""
    cache = {}

    def get(which, spin_adapt):
        if (which, spin_adapt) not in cache:
            op = sigma_df.xtda_sigma_df(sigma_df.build_df_data(refs[which][1]),
                                        spin_adapt=spin_adapt, with_b=True)
            ab = op.matvec(torch.eye(op.dim, dtype=torch.float64)).numpy()
            cache[which, spin_adapt] = (ab[0].T, ab[1].T)
        return cache[which, spin_adapt]

    return get


# (reference, port driver kwargs, JAX driver name)
DF_CASES = {
    "xtdhf": ("roks", "XTDHF", {"nstates": 4}),
    "tdhf_singlet": ("rhf", "TDHF", {"nstates": 3, "singlet": True}),
    "tdhf_triplet": ("rhf", "TDHF", {"nstates": 3, "singlet": False}),
    "utdhf": ("uhf", "UTDHF", {"nstates": 4}),
}


@pytest.mark.parametrize("name", list(DF_CASES))
def test_df_drivers(mfs, refs, own_pencil, name):
    which, cls, kw = DF_CASES[name]
    jmf, mf = mfs[which]
    ref = refs[which][1]
    res = getattr(drivers, cls)(ref, backend="df", **kw).kernel()
    assert res.converged and res.solver == "rpa-davidson+stabcheck"
    n = kw["nstates"]
    assert res.e.shape == (n,)
    # <X+Y|X-Y> = 1 (the closed-shell amplitudes sqrt(2) za carry it too)
    np.testing.assert_allclose(np.einsum("ds,ds->s", res.v, res.v_xmy), 1.0, atol=1e-6)
    A, B = own_pencil(which, cls == "XTDHF")
    if cls == "TDHF":
        w, xpy, _ = tdhf.solve_casida(A, B, A.shape[0])
        na = ref.nc * ref.nv
        par = np.einsum("ds,ds->s", xpy[:na], xpy[na:])
        own = w[(par > 0) if kw["singlet"] else (par < 0)][:n]
    else:
        own = tdhf.solve_casida(A, B, n)[0]
    np.testing.assert_allclose(res.e * units.HA2EV, own * units.HA2EV, rtol=0, atol=PENCIL_EV)
    jd = getattr(jax_drivers, cls)(jmf, backend="dense", **kw).kernel()
    np.testing.assert_allclose(res.e * units.HA2EV, np.asarray(jd.e) * units.HA2EV, rtol=0,
                               atol=FIT_EV)
    dense = getattr(drivers, cls)(ref, backend="dense", **kw).kernel()
    assert dense.solver == "dense-casida"
    np.testing.assert_allclose(dense.e * units.HA2EV, np.asarray(jd.e) * units.HA2EV, rtol=0,
                               atol=PENCIL_EV)
    for k in ("osc", "rot", "ds2"):
        if getattr(jd, k) is not None:
            np.testing.assert_allclose(getattr(dense, k), np.asarray(getattr(jd, k)), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("shape,flop,ms", [
    ((4412, 20, 137, 45), 9.8e10, 1.46),     # TTM/STO-3G alpha block, the JAX order
    ((2000, 20, 80, 920), 9.4e11, 14.1),     # the bench block, the other order
    ((3990, 20, 137, 461), 2.8e12, 41.5),    # TTM/dzp alpha block
], ids=["ttm", "bench", "dzp"])
def test_rpa_exchange_counts(shape, flop, ms):
    """K1's RPA mode: 4*naux*nz*nocc*nvir*min(nocc, nvir) flops, bound by
    them at 67 TFLOP/s; the paired build adds one per spin block to the
    X-TDA count, two with an RSH's long-range pass."""
    from xtddft_tpu_torch.response import flops

    f = flops.rpa_exchange_flops(*shape)
    assert f == pytest.approx(flop, rel=0.02)
    got, by = flops.bound_ms(f, flops.rpa_exchange_bytes(*shape, 8), "float64")
    assert by == "operations" and got == pytest.approx(ms, rel=0.02)
    nc, no, nv, naux, nb = 136, 1, 45, 4412, 20
    for hyb_terms in (1, 2):
        extra = (flops.matvec_flops(nc, no, nv, naux, 1000, nb, hyb_terms, with_b=True)
                 - flops.matvec_flops(nc, no, nv, naux, 1000, nb, hyb_terms))
        assert extra == pytest.approx(hyb_terms * (flops.rpa_exchange_flops(naux, nb, nc + no, nv)
                                                   + flops.rpa_exchange_flops(naux, nb, nc,
                                                                              no + nv)))

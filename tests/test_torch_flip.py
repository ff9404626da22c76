"""The port's spin-flip leg against the JAX package, f64 on the CPU.

(a) `sf_sigma_df` (up, down; methods 0, 2) and `xsf_sigma_df` (SA 0-3,
    ``remove`` on and off) on FH/6-31G triplet ROKS, each package building
    its own reference and DF data from the same checkpoint: matvec, hdiag,
    init_guess and the blocked layout, to relative 1e-10;
(b) the same on a JAX ``synthetic_df_data`` carried across with
    ``df_data_from_arrays`` (there also method 1, the multicollinear
    kernel), and with random UKS twins (``B_b``, ``phi_b``)
    added on both sides, through `xtda_sigma_df` too; and with a
    range-separated hybrid's long-range tensor (``B_lr``, ``hyb_lr``) or a
    TPSSh tau pair added on both sides;
(c) the SF kernels (`sf_kernel_alda0` on the FH grid, `sf_kernel_mcol` on
    the synthetic one), to relative 1e-9;
(d) `delta_a_tensors_from_df` and `apply_delta_a` alone, to relative 1e-12;
(e) the slice whole: `XSFTDA` (SA=3) and `SFTDA` (up, down) through the
    public drivers, energies within 1e-8 Ha, <dS^2> within 1e-6;
(f) a doublet (no=1, ``remove``): the OO block has no column at all;
(g) the frozen-core restriction `_restrict_sigma_op`, alone and through
    `XSFTDA.kernel(frozen=1)`;
(h) the host pieces that `SFTDA` and `XSFTDA` read (`response/spaces.py`, the two
    <dS^2> diagnostics of `props/spin.py`), and the point-span loop of the
    flip grid contraction against one span.
"""

import dataclasses
import hashlib
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xtddft_tpu.methods import drivers as jax_drivers
from xtddft_tpu.props import spin as jax_spin
from xtddft_tpu.response import sigma_df as jax_sigma_df
from xtddft_tpu.response import spaces as jax_spaces
from xtddft_tpu.response import xsf_terms as jax_xsf_terms
from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu.xc import interface as jax_xci
from xtddft_tpu.xc import registry as jax_registry
from xtddft_tpu_torch.methods import drivers
from xtddft_tpu_torch.props import spin
from xtddft_tpu_torch.response import sigma_df, spaces, xsf_terms
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf.checkpoint import load_mf
from xtddft_tpu_torch.xc import interface as xci
from xtddft_tpu_torch.xc.mcol import sf_kernel_mcol

CKPT = str(pathlib.Path(__file__).parent / "data" / "fh_entry_ckpt.npz")
RTOL = 1e-10
NZ = 3

# the multicollinear kernel (method 1) is held on the synthetic grid (2048
# points); the JAX side traces its vmapped Hessian (seconds) once
SF_CASES = [(s, e, m) for s in ("fh", "synthetic") for e in ("up", "down")
            for m in ((0, 1, 2) if s == "synthetic" else (0, 2))]
XSF_CASES = [(sa, rm) for sa in (0, 1, 2, 3) for rm in (True, False)]


def _rel_close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _carry(jdata):
    """A JAX DFData as the port's, through host arrays."""
    fields = {f.name: getattr(jdata, f.name) for f in dataclasses.fields(jdata)}
    fields["rho0"] = [np.asarray(r) for r in jdata.rho0]
    for k in ("B", "phi", "grid_w", "B_b", "phi_b", "B_lr", "B_lr_b"):
        if fields.get(k) is not None:
            fields[k] = np.asarray(fields[k])
    return sigma_df.df_data_from_arrays(fields, jdata.spec.name, device="cpu",
                                        dtype=torch.float64)


@pytest.fixture(scope="module", autouse=True)
def mcol_kernels_once():
    """Each package's multicollinear kernel is computed once per input for
    the whole file (each JAX call re-traces its vmapped Hessian), keyed by
    the bytes of its weights and densities (the up and down flips, the
    meta-GGA cases and the span test share theirs) and, for the port, by
    its batch size, so that the chunked run is computed anew."""
    from xtddft_tpu.xc import mcol as jax_mcol
    from xtddft_tpu_torch.xc import mcol

    real_jax, real_port, cache = jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol, {}

    def key_of(spec, weights, rho0, nt):
        return (spec.name, nt) + tuple(
            hashlib.sha1(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()
            for a in (weights, *rho0))

    def jax_kernel(spec, weights, rho0, nt=20):
        key = ("jax",) + key_of(spec, weights, rho0, nt)
        if key not in cache:
            cache[key] = real_jax(spec, weights, rho0, nt)
        return cache[key]

    def port_kernel(spec, weights, rho0, nt=20):
        key = ("port", mcol.MCOL_POINTS) + key_of(spec, weights, rho0, nt)
        if key not in cache:
            cache[key] = real_port(spec, weights, rho0, nt)
        return cache[key]

    jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol = jax_kernel, port_kernel
    yield
    jax_mcol.sf_kernel_mcol, mcol.sf_kernel_mcol = real_jax, real_port


@pytest.fixture(scope="module")
def mean_fields():
    return (jax_load_mf(CKPT, df=True),
            load_mf(CKPT, df=True, device="cpu", dtype=torch.float64))


@pytest.fixture(scope="module")
def references(mean_fields):
    jmf, mf = mean_fields
    return jax_make_reference(jmf), make_reference(mf)


@pytest.fixture(scope="module")
def sources(references):
    """name -> (JAX DFData, the port's DFData); one JAX DF build for FH."""
    jfh = jax_sigma_df.build_df_data(references[0])
    fh = sigma_df.build_df_data(references[1])
    jsyn = jax_sigma_df.synthetic_df_data(nmo=48, nc=8, no=2, naux=96, ngrid=2048,
                                          dtype=np.float64)
    # UKS twins: a second, symmetric B and a second MO table on both sides
    rng = np.random.default_rng(7)
    Bb = rng.normal(size=jsyn.B.shape) / np.sqrt(96 * 48)
    Bb = 0.5 * (Bb + Bb.transpose(0, 2, 1))
    phib = rng.normal(size=jsyn.phi.shape) / np.sqrt(48)
    juks = dataclasses.replace(jsyn, B_b=jnp.asarray(Bb), phi_b=jnp.asarray(phib))
    return {"fh": (jfh, fh), "synthetic": (jsyn, _carry(jsyn)), "uks": (juks, _carry(juks))}


def _check_operator(jop, op, seed):
    assert op.dim == jop.dim
    z = np.random.default_rng(seed).normal(size=(NZ, op.dim))
    _rel_close(op.matvec(torch.as_tensor(z)), jop.matvec(z))
    _rel_close(op.hdiag, jop.hdiag)
    n = min(4, op.dim)
    np.testing.assert_array_equal(op.init_guess(n), jop.init_guess(n))
    v = np.random.default_rng(seed + 1).normal(size=(op.dim, 2))
    np.testing.assert_array_equal(op.to_blocked(v), jop.to_blocked(v))


@pytest.mark.parametrize("src,extype,method", SF_CASES,
                         ids=[f"{s}-{e}-m{m}" for s, e, m in SF_CASES])
def test_sf_sigma_df(sources, src, extype, method):
    jdata, data = sources[src]
    _check_operator(jax_sigma_df.sf_sigma_df(jdata, extype, method),
                    sigma_df.sf_sigma_df(data, extype, method), 3)


@pytest.mark.parametrize("SA,remove", XSF_CASES,
                         ids=[f"SA{s}-{'remove' if r else 'full'}" for s, r in XSF_CASES])
@pytest.mark.parametrize("src", ["fh", "synthetic"])
def test_xsf_sigma_df(sources, src, SA, remove):
    jdata, data = sources[src]
    kw = dict(SA=SA, remove=remove, foo=0.9, fglobal=0.7)
    _check_operator(jax_sigma_df.xsf_sigma_df(jdata, **kw),
                    sigma_df.xsf_sigma_df(data, **kw), 5)


def test_xsf_sigma_df_multicollinear(sources):
    jdata, data = sources["synthetic"]
    kw = dict(SA=3, remove=True, method=1, fglobal=0.4)
    _check_operator(jax_sigma_df.xsf_sigma_df(jdata, **kw),
                    sigma_df.xsf_sigma_df(data, **kw), 9)


@pytest.mark.parametrize("which", ["xtda", "sf-up", "sf-down", "xsf-SA0"])
def test_uks_twins(sources, which):
    """Random ``B_b`` and ``phi_b``: the beta block of the spin-conserving
    sigma and the cross-spin panels of the flip sigmas read them."""
    jdata, data = sources["uks"]
    make = {
        "xtda": lambda m, d: m.xtda_sigma_df(d),
        "sf-up": lambda m, d: m.sf_sigma_df(d, "up", 0),
        "sf-down": lambda m, d: m.sf_sigma_df(d, "down", 0),
        "xsf-SA0": lambda m, d: m.xsf_sigma_df(d, SA=0, remove=False),
    }[which]
    jop, op = make(jax_sigma_df, jdata), make(sigma_df, data)
    z = np.random.default_rng(13).normal(size=(NZ, op.dim))
    got = op.matvec(torch.as_tensor(z))
    _rel_close(got, jop.matvec(z))
    # and they matter: without the twins the result differs
    plain = make(sigma_df, dataclasses.replace(data, B_b=None, phi_b=None))
    assert float((plain.matvec(torch.as_tensor(z)) - got).abs().max()) > 1e-6


@pytest.mark.parametrize("kernel", ["alda0", "mcol"])
def test_sf_kernels(sources, kernel):
    jdata, data = sources["fh" if kernel == "alda0" else "synthetic"]
    if kernel == "alda0":
        want = jax_xci.sf_kernel_alda0(jdata.spec, jdata.grid_w, jdata.rho0)
        got = xci.sf_kernel_alda0(data.spec, data.grid_w, data.rho0)
    else:
        from xtddft_tpu.xc import mcol as jax_mcol

        want = jax_mcol.sf_kernel_mcol(jdata.spec, jdata.grid_w, jdata.rho0)
        got = sf_kernel_mcol(data.spec, data.grid_w, data.rho0)
        assert got.shape == (data.grid_w.shape[0], 4, 4)
    _rel_close(got, want, 1e-9)


def test_mcol_chunks_agree(sources, monkeypatch):
    """The multicollinear kernel in grid chunks equals the one-batch result."""
    from xtddft_tpu_torch.xc import mcol

    _, data = sources["synthetic"]
    whole = mcol.sf_kernel_mcol(data.spec, data.grid_w, data.rho0, nt=6)
    monkeypatch.setattr(mcol, "MCOL_POINTS", 700)
    _rel_close(mcol.sf_kernel_mcol(data.spec, data.grid_w, data.rho0, nt=6), whole, 1e-13)


@pytest.mark.parametrize("SA", [1, 3])
def test_delta_a_terms(sources, SA, monkeypatch):
    jdata, data = sources["synthetic"]
    nc, no, nv = data.nc, data.no, data.nv
    # a panel budget small enough that every tensor is accumulated over aux chunks
    monkeypatch.setattr(xsf_terms, "PANEL_BUDGET_BYTES", 40_000)
    jT = jax_xsf_terms.delta_a_tensors_from_df(jdata.B, nc, no, SA, np.float64)
    T = xsf_terms.delta_a_tensors_from_df(data.B, nc, no, SA)
    assert sorted(T) == sorted(jT)
    for k in jT:
        _rel_close(T[k], jT[k], 1e-12)
    jT.update(jax_xsf_terms.delta_a_fock_blocks(jdata.fock_hf_mo[0], jdata.fock_hf_mo[1],
                                                nc, no, np.float64))
    T.update(xsf_terms.delta_a_fock_blocks(data.fock_hf_mo[0], data.fock_hf_mo[1], nc, no,
                                           torch.float64, "cpu"))
    rng = np.random.default_rng(SA)
    blocks = [rng.normal(size=(NZ, *s)) for s in ((nc, nv), (nc, no), (no, nv), (no, no))]
    want = jax_xsf_terms.apply_delta_a(jT, 0.5 * no, SA, 0.8, *map(jnp.asarray, blocks),
                                       np.float64)
    got = xsf_terms.apply_delta_a(T, 0.5 * no, SA, 0.8, *map(torch.as_tensor, blocks))
    for g, w in zip(got, want):
        _rel_close(g, w, 1e-12)


@pytest.mark.parametrize("method", ["xsf", "sf-up", "sf-down"])
def test_drivers(mean_fields, method):
    """The slice whole, through the public entry points of both packages."""
    jmf, mf = mean_fields
    if method == "xsf":
        want = jax_drivers.XSFTDA(jmf, nstates=4, SA=3, backend="df").kernel()
        got = drivers.XSFTDA(mf, nstates=4, SA=3, backend="df").kernel()
        assert got.ds2 is None and want.ds2 is None  # fixed by the spin adaptation
    else:
        extype = method[3:]
        want = jax_drivers.SFTDA(jmf, nstates=4, extype=extype, backend="df").kernel()
        got = drivers.SFTDA(mf, nstates=4, extype=extype, backend="df").kernel()
        if extype == "down":
            np.testing.assert_allclose(got.ds2, want.ds2, rtol=0, atol=1e-6)
        else:
            assert got.ds2 is None and want.ds2 is None
    assert got.converged and want.converged
    assert got.v.shape == np.asarray(want.v).shape
    np.testing.assert_allclose(got.e, np.asarray(want.e), rtol=0, atol=1e-8)


def test_doublet_has_no_oo_column(sources):
    """no = 1 with ``remove``: the projected OO block is (1, 0), the trial
    vector carries no OO entry, and the build passes through the empty slice.
    (The synthetic arrays read as nc 8, no 1, nv 39.)"""
    jsyn, syn = sources["synthetic"]
    jdata = dataclasses.replace(jsyn, no=1, nv=jsyn.nv + 1)
    data = dataclasses.replace(syn, no=1, nv=syn.nv + 1)
    jop = jax_sigma_df.xsf_sigma_df(jdata, SA=0, remove=True)
    op = sigma_df.xsf_sigma_df(data, SA=0, remove=True)
    assert op.dim == 8 * 39 + 8 * 1 + 1 * 39
    _check_operator(jop, op, 17)
    v = np.random.default_rng(1).normal(size=(op.dim, 2))
    full = op.to_blocked(v)
    assert full.shape == (op.dim + 1, 2) and not full[-1].any()


def test_restrict_sigma_op(sources):
    """Frozen core (frozen=1, remove=False) as `XSFTDA` restricts it."""
    jdata, data = sources["fh"]
    nc, no, nv = data.nc, data.no, data.nv
    jop = jax_sigma_df.xsf_sigma_df(jdata, SA=3, remove=False)
    op = sigma_df.xsf_sigma_df(data, SA=3, remove=False)
    d1, d2 = nc * nv, nc * nv + nc * no
    keep = np.r_[nv: d1, d2 - (nc - 1) * no: op.dim]
    _check_operator(jax_drivers._restrict_sigma_op(jop, keep),
                    drivers._restrict_sigma_op(op, keep), 21)


def test_driver_refusals(mean_fields):
    _, mf = mean_fields
    with pytest.raises(ValueError, match="remove=False"):
        drivers.XSFTDA(mf, nstates=2).kernel(frozen=1)
    with pytest.raises(ValueError, match="exceeds nc"):
        drivers.XSFTDA(mf, nstates=2).kernel(frozen=99, remove=False)
    with pytest.raises(ValueError, match="frozen core requires"):
        drivers.XSFTDA(mf, nstates=2, backend="incore").kernel(frozen=1, remove=False)
    with pytest.raises(ValueError, match="backend"):
        drivers.SFTDA(mf, nstates=2, backend="bogus").kernel()
    with pytest.raises(ValueError, match="extype"):
        drivers.SFTDA(mf, nstates=2, extype="sideways").kernel()


def test_doublet_refuses_spin_adaptation(references):
    ref = references[1]
    with pytest.raises(ValueError, match="S >= 1"):
        drivers.XSFTDA(dataclasses.replace(ref, no=1, nv=ref.nv + 1), SA=3).kernel()


@pytest.mark.parametrize("build", ["sf", "xsf"])
@pytest.mark.parametrize("option", ["spmd", "packed"])
def test_options_not_ported_raise(build, option):
    """Each option that is not ported raises, naming its ROADMAP item (the
    RSH and meta-GGA options are ported since: test_rsh_and_mgga_match_jax)."""
    data = sigma_df.synthetic_df_data(nmo=12, nc=3, no=2, naux=8, ngrid=64,
                                      device="cpu", dtype=torch.float64)
    make = sigma_df.sf_sigma_df if build == "sf" else sigma_df.xsf_sigma_df
    kw = {}
    if option == "spmd":
        kw["spmd"] = True
    else:
        data = dataclasses.replace(data, packed=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        make(data, **kw)


def _with_rsh(jdata, seed=11):
    """The synthetic data with a second symmetric tensor as the long-range
    fit B_lr (and its beta twin where the data has one), at CAM-B3LYP's
    alpha - hyb."""
    rng = np.random.default_rng(seed)

    def sym_like(B):
        a = rng.normal(size=B.shape) / np.sqrt(B.shape[0] * B.shape[1])
        return jnp.asarray(0.5 * (a + a.transpose(0, 2, 1)))

    kw = {"B_lr": sym_like(jdata.B), "hyb_lr": 0.46}
    if jdata.B_b is not None:
        kw["B_lr_b"] = sym_like(jdata.B_b)
    return dataclasses.replace(jdata, **kw)


def _with_tau(jdata, seed=12):
    """The synthetic data as a TPSSh reference: the tau pair on the grid,
    above the von Weizsaecker bound (well conditioned, as tests/test_mgga.py
    keeps its points)."""
    rng = np.random.default_rng(seed)
    ra, rb, ga, gb = (np.asarray(r) for r in jdata.rho0)
    ng = ra.shape[0]
    taus = tuple(jnp.asarray(np.einsum("xg,xg->g", g, g) / (8 * r) * rng.uniform(1.5, 4.0, ng)
                             + 0.05 * r) for r, g in ((ra, ga), (rb, gb)))
    return dataclasses.replace(jdata, spec=jax_registry.resolve("tpssh"), hyb=0.1,
                               rho0=tuple(jdata.rho0) + taus)


RSH_MGGA_CASES = {
    "sf-rsh": (lambda m, d: m.sf_sigma_df(d, "down", 0), "rsh"),
    "sf-up-rsh-uks": (lambda m, d: m.sf_sigma_df(d, "up", 0), "rsh-uks"),
    "xsf-rsh": (lambda m, d: m.xsf_sigma_df(d, SA=3), "rsh"),
    "xtda-rsh-uks": (lambda m, d: m.xtda_sigma_df(d), "rsh-uks"),
    "sf-mgga-mcol": (lambda m, d: m.sf_sigma_df(d, "down", 1), "mgga"),
    "xsf-mgga-mcol": (lambda m, d: m.xsf_sigma_df(d, SA=3, method=1), "mgga"),
    "xtda-mgga": (lambda m, d: m.xtda_sigma_df(d), "mgga"),
}


@pytest.mark.parametrize("case", list(RSH_MGGA_CASES))
def test_rsh_and_mgga_match_jax(sources, case):
    """The RSH long-range exchange (a second, exchange-only K1 pass on B_lr
    scaled by hyb_lr) and the meta-GGA tau channel (K2's tau row, K3's tau
    term, the five-component multicollinear kernel) on synthetic data
    carried across, against the JAX sigmas."""
    make, option = RSH_MGGA_CASES[case]
    jdata = sources["uks" if option == "rsh-uks" else "synthetic"][0]
    jdata = _with_tau(jdata) if option == "mgga" else _with_rsh(jdata)
    _check_operator(make(jax_sigma_df, jdata), make(sigma_df, _carry(jdata)), 40)


@pytest.mark.parametrize("which", ["sf-down-mcol", "xsf"])
def test_grid_spans_agree(sources, which, monkeypatch):
    """The SF grid contraction walked in several point spans equals one span."""
    _, data = sources["synthetic"]
    make = {"sf-down-mcol": lambda: sigma_df.sf_sigma_df(data, "down", 1),
            "xsf": lambda: sigma_df.xsf_sigma_df(data, SA=3)}[which]
    op = make()
    z = torch.as_tensor(np.random.default_rng(2).normal(size=(NZ, op.dim)))
    whole = op.matvec(z)
    # 2048 points, 3 vectors: spans of 233 (ALDA0) or 58 (four components) points
    monkeypatch.setattr(sigma_df, "SF_SPAN_ELEMS", 700)
    _rel_close(make().matvec(z), whole.numpy(), 1e-13)


@pytest.mark.parametrize("fn", ["order_interleaved2blocked", "so2st", "st2so"])
def test_spaces_match_jax(fn):
    nc, no, nv = 4, 3, 5
    if fn == "order_interleaved2blocked":
        np.testing.assert_array_equal(spaces.order_interleaved2blocked(nc, no, nv),
                                      jax_spaces.order_interleaved2blocked(nc, no, nv))
        return
    v = np.random.default_rng(12).normal(size=((nc + no) * nv + nc * (no + nv), 3))
    np.testing.assert_array_equal(getattr(spaces, fn)(v, nc, no, nv),
                                  getattr(jax_spaces, fn)(v, nc, no, nv))


@pytest.mark.parametrize("no", [1, 2, 3])
def test_sf_oo_projector_matches_jax(no):
    """(no^2, no^2 - 1), orthonormal, orthogonal to the trace direction."""
    V = spaces.sf_oo_projector(no)
    np.testing.assert_array_equal(V, jax_spaces.sf_oo_projector(no))
    assert V.shape == (no * no, no * no - 1)
    np.testing.assert_allclose(V.T @ V, np.eye(no * no - 1), atol=1e-14)
    np.testing.assert_allclose(np.eye(no).ravel() @ V, 0.0, atol=1e-14)


@pytest.mark.parametrize("kind", ["roks", "uks"])
def test_flip_delta_s2_matches_jax(references, kind):
    """The two flip-down <dS^2> diagnostics on random full-layout vectors."""
    jref, ref = references
    dim = (ref.nc + ref.no) * (ref.no + ref.nv)
    v = np.random.default_rng(23).normal(size=(dim, 3))
    v /= np.linalg.norm(v, axis=0)
    name = f"xsf_delta_s2_{kind}"
    np.testing.assert_allclose(getattr(spin, name)(ref, v), getattr(jax_spin, name)(jref, v),
                               rtol=0, atol=1e-10)


def test_xsftda_frozen_core(mean_fields):
    """`XSFTDA.kernel(frozen=1, remove=False)` through both packages."""
    jmf, mf = mean_fields
    want = jax_drivers.XSFTDA(jmf, nstates=3, SA=3, backend="df").kernel(frozen=1, remove=False)
    got = drivers.XSFTDA(mf, nstates=3, SA=3, backend="df").kernel(frozen=1, remove=False)
    assert got.converged and got.v.shape == np.asarray(want.v).shape
    np.testing.assert_allclose(got.e, np.asarray(want.e), rtol=0, atol=1e-8)

"""The port's property layer and its RSH DF sigmas against the JAX package, f64, CPU.

(a) `props/tdm.py`: every state-pair case on seeded CI blocks and a seeded
    operator (relative 1e-12);
(b) `props/diagnostics.py` `spin_polarization` (methods 0 and 2) on a
    triplet ROKS/CAM-B3LYP reference (linear H-O-H, STO-3G, grid 1; the
    JAX SCF carried into the port through the shared checkpoint format),
    whose SF response carries the long-range exchange (1e-10);
(c) `props/export.py`: the results table, the broadened spectrum and its
    CSV file text-identical to the JAX package's, and the .npz round trip
    within the port and across the two packages;
(d) the range-separated hybrid on the DF route: the port's own
    erf-attenuated fit ``B_lr`` of the same reference against the JAX one
    (relative 1e-8: the fit metric's conditioning scales the few-ulp
    difference of the two builds of the integral engine, as
    tests/test_torch_host_layer.py holds B), then the X-TDA, SF-TDA and
    XSF-TDA sigmas with it (a second, exchange-only K1 pass scaled by
    alpha - hyb) on the JAX DF data carried across (relative 1e-10).

One JAX SCF and one JAX DF build for the whole file.
"""

import dataclasses

import numpy as np
import pytest
import torch

from xtddft_tpu.chem import Molecule as JaxMolecule
from xtddft_tpu.methods.drivers import ExcitationResult as JaxExcitationResult
from xtddft_tpu.props import diagnostics as jax_diagnostics
from xtddft_tpu.props import export as jax_export
from xtddft_tpu.props import tdm as jax_tdm
from xtddft_tpu.response import sigma_df as jax_sigma_df
from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf import ROKS as JaxROKS
from xtddft_tpu.scf.checkpoint import save_mf as jax_save_mf
from xtddft_tpu_torch.methods.drivers import ExcitationResult
from xtddft_tpu_torch.props import diagnostics, export, tdm
from xtddft_tpu_torch.response import sigma_df
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf.checkpoint import load_mf


HOH = "O 0 0 0; H 0 0 0.98; H 0 0 -0.98"
RTOL = 1e-12
SIGMA_RTOL = 1e-10


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel_close(got, want, rtol):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# ---- (a) transition-density contractions ----

def _blocks(rng, n, kind):
    nc, no, nv = n
    shapes = {"S-": [(nc, nv), (nc, no), (no, nv), (no, no), (no,)],
              "S": [(nc, nv), (nc, no), (no, nv), (nc, nv)],
              "S+": [(nc, nv)], "GS": []}[kind]
    return [rng.normal(size=s) for s in shapes]


TDM_CASES = [("tdm_gsgs", 1, "GS", "GS"), ("tdm_gss", 0, "GS", "S"), ("tdm_gss", 1, "GS", "S"),
             ("tdm_sgs", 1, "S", "GS"), ("tdm_s", 0, "S", "S"), ("tdm_s", 1, "S", "S"),
             ("tdm_s1", 1, "S+", "S+"), ("tdm_s_1", 1, "S-", "S-"), ("tdm_s_1", 1.5, "S-", "S-")]


@pytest.mark.parametrize("name,S,left,right", TDM_CASES,
                         ids=[f"{c[0]}-S{c[1]}" for c in TDM_CASES])
def test_tdm_matches_jax(name, S, left, right):
    rng = np.random.default_rng(5)
    n = (3, 2, 4)
    ints = rng.normal(size=(3, sum(n), sum(n)))
    XL, XR = _blocks(rng, n, left), _blocks(rng, n, right)
    want = getattr(jax_tdm, name)(S, XL, XR, ints, n)
    got = getattr(tdm, name)(S, XL, XR, ints, n)
    assert np.shape(got) == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * max(1.0, np.abs(want).max()))


# ---- (b), (d) the triplet ROKS/CAM-B3LYP reference ----

@pytest.fixture(scope="module")
def hoh(tmp_path_factory):
    """(JAX Reference, the port's Reference) of one JAX SCF, carried across."""
    jmf = JaxROKS(JaxMolecule.from_atoms(HOH, basis="sto-3g", spin=2), xc="camb3lyp",
                  grid_level=1).kernel()
    assert jmf.converged
    path = str(tmp_path_factory.mktemp("props") / "hoh.npz")
    jax_save_mf(jmf, path)
    ref = make_reference(load_mf(path, device="cpu"))
    assert ref.omega != 0.0 and ref.no == 2
    return jax_make_reference(jmf), ref


@pytest.mark.parametrize("method", [0, 2], ids=["alda0", "collinear"])
def test_spin_polarization_matches_jax(hoh, method, capsys):
    jref, ref = hoh
    want = jax_diagnostics.spin_polarization(jref, method=method)
    got = diagnostics.spin_polarization(ref, method=method, report=True)
    assert abs(got["lhhl"] - want["lhhl"]) < 1e-10
    for k in ("homo", "lumo"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10)
    assert "<LH|HL>" in capsys.readouterr().out


def test_spin_polarization_rejects_non_triplet(hoh):
    ref = hoh[1]
    with pytest.raises(ValueError, match="triplet"):
        diagnostics.spin_polarization(dataclasses.replace(ref, no=1, nv=ref.nv + 1))


B_LR_RTOL = 1e-8


@pytest.fixture(scope="module")
def hoh_df(hoh):
    """(JAX DFData, the JAX DFData carried across, the port's own): one JAX
    DF build."""
    jref, ref = hoh
    jdata = jax_sigma_df.build_df_data(jref)
    fields = {f: getattr(jdata, f) for f in ("nc", "no", "nv", "B", "fock_mo", "hyb", "phi",
                                             "grid_w", "fock_hf_mo", "B_lr", "hyb_lr")}
    fields["rho0"] = [np.asarray(r) for r in jdata.rho0]
    carried = sigma_df.df_data_from_arrays(fields, jdata.spec.name, device="cpu",
                                           dtype=torch.float64)
    return jdata, carried, sigma_df.build_df_data(ref)


def test_rsh_df_data_matches_jax(hoh_df):
    jdata, _, data = hoh_df
    assert data.hyb_lr == pytest.approx(jdata.hyb_lr) == pytest.approx(0.46)
    _rel_close(data.B_lr, jdata.B_lr, B_LR_RTOL)


RSH_OPS = {
    "xtda": lambda m, d: m.xtda_sigma_df(d),
    "sf_down": lambda m, d: m.sf_sigma_df(d, "down", 0),
    "sf_up": lambda m, d: m.sf_sigma_df(d, "up", 0),
    "xsf_sa3": lambda m, d: m.xsf_sigma_df(d, SA=3),
}


@pytest.mark.parametrize("name", list(RSH_OPS))
def test_rsh_df_sigma_matches_jax(hoh_df, name):
    jdata, data, _ = hoh_df
    jop, op = RSH_OPS[name](jax_sigma_df, jdata), RSH_OPS[name](sigma_df, data)
    assert op.dim == jop.dim
    z = np.random.default_rng(7).normal(size=(3, op.dim))
    _rel_close(op.matvec(torch.as_tensor(z)), jop.matvec(z), SIGMA_RTOL)
    # the long-range pass is there: without it the sigma moves
    short = RSH_OPS[name](sigma_df, dataclasses.replace(data, B_lr=None, hyb_lr=0.0))
    assert np.abs(_np(short.matvec(torch.as_tensor(z))) - np.asarray(jop.matvec(z))).max() > 1e-4


# ---- (c) export ----

def _results():
    rng = np.random.default_rng(9)
    n, dim = 4, 7
    arrays = {"e": np.sort(rng.uniform(0.05, 0.4, n)), "v": rng.normal(size=(dim, n)),
              "osc": rng.uniform(0, 1, n), "rot": rng.normal(size=n), "ds2": rng.uniform(0, 2, n)}
    return (ExcitationResult(converged=True, **arrays),
            JaxExcitationResult(converged=True, **arrays))


def test_export_text_matches_jax(tmp_path):
    res, jres = _results()
    assert export.excitation_table(res, "T") == jax_export.excitation_table(jres, "T")
    no_props = ExcitationResult(e=res.e, v=res.v)
    assert "0.0000" in export.excitation_table(no_props)
    x, y = export.uv_spectrum(res, e_max_ev=12.0)
    jx, jy = jax_export.uv_spectrum(jres, e_max_ev=12.0)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-14)
    export.save_spectrum_csv(res, str(tmp_path / "a.csv"))
    jax_export.save_spectrum_csv(jres, str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_results_round_trip(tmp_path, writer):
    """save_results / load_results: the port reads its own files and the JAX
    package's, and the JAX package reads the port's."""
    res, jres = _results()
    path = str(tmp_path / "r.npz")
    (export.save_results(res, path) if writer == "port" else jax_export.save_results(jres, path))
    for back in (export.load_results(path), jax_export.load_results(path)):
        for k in ("e", "v", "osc", "rot", "ds2"):
            np.testing.assert_array_equal(getattr(back, k), getattr(res, k))
        assert back.converged is True
    assert isinstance(export.load_results(path), ExcitationResult)

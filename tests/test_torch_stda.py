"""The port's simplified TDA (`stda/`) against the JAX package, f64 on the CPU.

On FH/6-31G BHandHLYP triplets at grid 1, the ROKS (the JAX session fixture
``fh_roks``, carried into the port) for sX-TDA and the port's UKS (carried
into the JAX package) for sU-TDA, each package building its own Reference:

- the gamma kernels, the Löwdin charges and K4's plain version (against the
  JAX ``_j_block`` and the Coulomb diagonal of ``csf_diagonal``),
  elementwise to 1e-12;
- ``STDA`` at its defaults and at a wider window with a coarser threshold:
  the same selected CSF sets, and roots (eV), oscillator and rotatory
  strengths and <dS^2> within 1e-8;
- ``Emax=None`` (no truncation) equals ``Emax=1e6`` (a window that keeps
  everything) to 1e-10;
- ``truncation_scan``'s CSV text equals the JAX package's (a difference of
  the last bits prints as "0.000000" in one and "-0.000000" in the other, so
  the sign of a printed zero is not compared).
"""

import numpy as np
import pytest
import torch

from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu.scf.checkpoint import save_mf as jax_save_mf
from xtddft_tpu.stda import STDA as JaxSTDA
from xtddft_tpu.stda import core as jax_core
from xtddft_tpu.stda import diagnostics as jax_diag
from xtddft_tpu_torch import units
from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.kernels import stda_coupling as k4
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf import UKS
from xtddft_tpu_torch.scf.checkpoint import load_mf, save_mf
from xtddft_tpu_torch.stda import STDA, core, diagnostics

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(scope="module")
def refs(fh_roks, tmp_path_factory):
    """{"roks" | "uks": (JAX Reference, port Reference)}."""
    tmp = tmp_path_factory.mktemp("stda")
    jax_save_mf(fh_roks, str(tmp / "roks.npz"))
    out = {"roks": (jax_make_reference(fh_roks),
                    make_reference(load_mf(str(tmp / "roks.npz"), device="cpu")))}
    mf = UKS(Molecule.from_atoms("F 0 0 0; H 0 0 1.0", basis="6-31g", spin=2),
             xc="bhandhlyp", grid_level=1, device="cpu").kernel()
    assert mf.converged
    save_mf(mf, str(tmp / "uks.npz"))
    out["uks"] = (jax_make_reference(jax_load_mf(str(tmp / "uks.npz"))), make_reference(mf))
    return out


@pytest.mark.parametrize("which", ["roks", "uks"])
def test_context_and_k4(refs, which):
    jref, ref = refs[which]
    spinadapt = which == "roks"
    act = core.select_active_space(ref, 10.0, ref.hyb)
    jact = jax_core.select_active_space(jref, 10.0, jref.hyb)
    assert (act.lo, act.hi, act.nc, act.no, act.nv) == (jact.lo, jact.hi, jact.nc, jact.no,
                                                         jact.nv)
    for got, want in zip(core.gamma_jk(ref.env.mol, ref.hyb),
                         jax_core.gamma_jk(jref.env.mol, jref.hyb)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    ctx = core.make_context(ref, act, spinadapt)
    jctx = jax_core.make_context(jref, jact, spinadapt)
    for s in (0, 1):
        for name in ("qk", "qj_oo", "qj_vv"):
            np.testing.assert_allclose(getattr(ctx, name)[s].numpy(),
                                       np.asarray(getattr(jctx, name)[s]), rtol=0, atol=1e-12)
    full = core.full_csf_set(act.nc, act.no, act.nv)
    occ, vir, spin = full.gather_arrays(act.nc, act.no)
    rng = np.random.default_rng(4)
    for s in (0, 1):
        rows = np.flatnonzero(spin == s)
        r, c = rng.choice(rows, 9), rows  # repeated rows, every column
        lr, lc = (k4.csf_list(occ[i], vir[i], ctx.nocc[s], ctx.nvir[s], "cpu") for i in (r, c))
        assert lr.occ.dtype == torch.int32 and lr.occ.device.type == "cpu"
        got = k4.j_block(ctx.g_oo[s], ctx.qj_vv[s], lr, lc)
        want = np.asarray(jax_core._j_block(jctx, s, occ[r], vir[r], occ[c], vir[c]))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
        # subtracted in place from a strided block, as coupling_matrix does
        M = torch.ones((len(r) + 3, len(c) + 5), dtype=got.dtype)
        k4.j_block(ctx.g_oo[s], ctx.qj_vv[s], lr, lc, out=M[2:-1, 1:-4])
        torch.testing.assert_close(M[2:-1, 1:-4], 1.0 - got, rtol=0, atol=0)
        assert (M[:2] == 1).all() and (M[-1] == 1).all() and (M[:, 0] == 1).all()
        np.testing.assert_allclose(k4.j_diagonal(ctx.g_oo[s], ctx.qj_vv[s], lc).numpy(),
                                   np.diagonal(np.asarray(jax_core._j_block(
                                       jctx, s, occ[c], vir[c], occ[c], vir[c]))),
                                   rtol=0, atol=1e-12)
        with pytest.raises(ValueError):  # an index out of range, where the list is made
            k4.csf_list(occ[r], vir[r] + ctx.nvir[s], ctx.nocc[s], ctx.nvir[s], "cpu")
    iaia, kd = core.csf_diagonal(ctx, full)
    jiaia, jkd = jax_core.csf_diagonal(jctx, full)
    np.testing.assert_allclose(iaia, jiaia, rtol=0, atol=1e-12)
    np.testing.assert_allclose(kd, jkd, rtol=0, atol=1e-12)


SETTINGS = {"default": {}, "wide": {"Emax": 20.0, "tp": 1e-3}, "correct": {"correct": True}}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("which", ["roks", "uks"])
def test_stda_matches_jax(refs, which, setting):
    jref, ref = refs[which]
    drv = STDA(ref, nstates=5, **SETTINGS[setting])
    res = drv.kernel()
    jdrv = JaxSTDA(jref, nstates=5, **SETTINGS[setting])
    jres = jdrv.kernel()
    assert drv.spinadapt == (which == "roks") and drv.selection == jdrv.selection
    for b in core.BLOCKS:
        for got, want in zip(drv.sel.idx[b], jdrv.sel.idx[b]):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(res.e_eV, np.asarray(jres.e) * units.HA2EV, rtol=0, atol=TOL)
    for k in ("osc", "rot", "ds2"):
        np.testing.assert_allclose(getattr(res, k), np.asarray(getattr(jres, k)), rtol=0,
                                   atol=TOL)
    text = drv.summary(res)
    assert "selected dim" in text and text.splitlines()[0] == (
        "sX-TDA results" if which == "roks" else "sU-TDA results")


@pytest.mark.parametrize("which", ["roks", "uks"])
def test_emax_none_is_the_full_space(refs, which):
    ref = refs[which][1]
    a = STDA(ref, Emax=None, nstates=5).kernel()
    b = STDA(ref, Emax=1e6, nstates=5).kernel()
    np.testing.assert_allclose(a.e, b.e, rtol=0, atol=1e-10)
    np.testing.assert_allclose(a.osc, b.osc, rtol=0, atol=1e-10)


def test_truncation_scan_csv(refs, tmp_path):
    jref, ref = refs["roks"]
    settings = [{"Emax": 8.0}, {"Emax": 12.0, "tp": 1e-3}, {"tp": 1e-5}]
    scan = diagnostics.truncation_scan(ref, settings, nstates=3)
    jscan = jax_diag.truncation_scan(jref, settings, nstates=3)
    diagnostics.save_scan_csv(scan, str(tmp_path / "port.csv"))
    jax_diag.save_scan_csv(jscan, str(tmp_path / "jax.csv"))

    def text(name):
        return (tmp_path / name).read_text().replace("-0.000000", "0.000000")

    assert text("port.csv") == text("jax.csv")
    drv = STDA(ref, Emax=8.0, nstates=3)
    drv.kernel()
    O = diagnostics.subspace_overlap(drv, drv)
    np.testing.assert_allclose(np.diag(O), 1.0, atol=1e-12)

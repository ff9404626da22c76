"""The port's block Davidson against JAX ``davidson_fulljit`` on the FH/6-31G
DF X-TDA operator: the same roots to 1e-8 Ha and the same converged count."""

import pathlib

import numpy as np
import pytest
import torch

from xtddft_tpu.response import sigma_df as jax_sigma_df
from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu.solver.davidson_jit import davidson_fulljit
from xtddft_tpu_torch.response import sigma_df
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf.checkpoint import load_mf
from xtddft_tpu_torch.solver.davidson import _max_space, davidson

CKPT = str(pathlib.Path(__file__).parent / "data" / "fh_entry_ckpt.npz")


@pytest.fixture(scope="module")
def ops():
    jop = jax_sigma_df.xtda_sigma_df(jax_sigma_df.build_df_data(
        jax_make_reference(jax_load_mf(CKPT, df=True))))
    op = sigma_df.xtda_sigma_df(sigma_df.build_df_data(make_reference(
        load_mf(CKPT, df=True, device="cpu", dtype=torch.float64))))
    return jop, op


@pytest.mark.parametrize("nroots,pick_positive,factor", [
    (5, True, 12),   # the settings XTDA.kernel uses
    (3, False, 2),   # a small space: exercises the restart
])
def test_roots_match_jax(ops, nroots, pick_positive, factor):
    jop, op = ops
    x0 = op.init_guess(nroots)
    e_j, _, conv_j, info_j = davidson_fulljit(
        jop.matvec_raw, jop.consts, jop.hdiag, nroots=nroots, init_guess=x0,
        tol=None, pick_positive=pick_positive, max_space_factor=factor,
        return_info=True)
    e, v, conv, info = davidson(op.matvec, op.hdiag, nroots=nroots, init_guess=x0,
                                tol=None, pick_positive=pick_positive,
                                max_space_factor=factor)
    np.testing.assert_allclose(e, np.asarray(e_j), rtol=0, atol=1e-8)
    assert int(conv.sum()) == int(np.asarray(conv_j).sum())
    assert v.shape == (op.dim, nroots)
    # residuals of the returned pairs are at the f64 default tolerance
    r = op.matvec(torch.as_tensor(v.T)).numpy() - e[:, None] * v.T
    assert np.all(np.linalg.norm(r, axis=1)[conv] < 1e-6)


@pytest.mark.parametrize("dim,nb,factor,want", [
    (58, 5, 12, 60), (58, 5, 2, 10), (1000, 21, 8, 168), (3, 4, 6, 8)])
def test_max_space_rounding(dim, nb, factor, want):
    """The rounding of `davidson_jit.py:397-404`."""
    assert _max_space(dim, nb, factor) == want

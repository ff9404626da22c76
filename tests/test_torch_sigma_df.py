"""The port's DF X-TDA sigma against the JAX one, f64 on the CPU, to relative
1e-10: matvec, hdiag and init_guess.

(a) FH/6-31G ROKS BHandHLYP, each package building its own reference and DF
    data from the same checkpoint (J, K, fxc and the dA terms);
(b) a JAX ``synthetic_df_data`` carried across with ``df_data_from_arrays``.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from xtddft_tpu.response import sigma_df as jax_sigma_df
from xtddft_tpu.response.reference_state import make_reference as jax_make_reference
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu_torch.response import sigma_df
from xtddft_tpu_torch.response.reference_state import make_reference
from xtddft_tpu_torch.scf.checkpoint import load_mf

CKPT = str(pathlib.Path(__file__).parent / "data" / "fh_entry_ckpt.npz")
RTOL = 1e-10
NZ = 4


def _rel_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _ops_fh():
    jop = jax_sigma_df.xtda_sigma_df(jax_sigma_df.build_df_data(
        jax_make_reference(jax_load_mf(CKPT, df=True))))
    data = sigma_df.build_df_data(make_reference(
        load_mf(CKPT, df=True, device="cpu", dtype=torch.float64)))
    return jop, sigma_df.xtda_sigma_df(data)


def _ops_synthetic():
    jdata = jax_sigma_df.synthetic_df_data(nmo=48, nc=8, no=2, naux=96,
                                           ngrid=2048, dtype=np.float64)
    fields = {f.name: getattr(jdata, f.name) for f in dataclasses.fields(jdata)}
    fields["rho0"] = [np.asarray(r) for r in jdata.rho0]
    for k in ("B", "phi", "grid_w"):
        fields[k] = np.asarray(fields[k])
    data = sigma_df.df_data_from_arrays(fields, jdata.spec.name, device="cpu",
                                        dtype=torch.float64)
    return jax_sigma_df.xtda_sigma_df(jdata), sigma_df.xtda_sigma_df(data)


@pytest.fixture(scope="module", params=["fh", "synthetic"])
def ops(request):
    return {"fh": _ops_fh, "synthetic": _ops_synthetic}[request.param]()


def test_matvec(ops):
    jop, op = ops
    assert op.dim == jop.dim
    z = np.random.default_rng(11).normal(size=(NZ, op.dim))
    want = np.asarray(jop.matvec(z))
    got = op.matvec(torch.as_tensor(z)).numpy()
    _rel_close(got, want)


def test_hdiag_and_init_guess(ops):
    jop, op = ops
    _rel_close(op.hdiag, jop.hdiag)
    np.testing.assert_array_equal(op.init_guess(5), jop.init_guess(5))


def test_blocked_layout(ops):
    jop, op = ops
    v = np.random.default_rng(5).normal(size=(op.dim, 3))
    np.testing.assert_array_equal(op.to_blocked(v), jop.to_blocked(v))


def test_options_not_ported_raise():
    data = sigma_df.synthetic_df_data(nmo=12, nc=3, no=1, naux=8, ngrid=64,
                                      device="cpu", dtype=torch.float64)
    for kw in ({"spmd": True}, {"with_b": True}):
        with pytest.raises(NotImplementedError):
            sigma_df.xtda_sigma_df(data, **kw)
    with pytest.raises(NotImplementedError):
        sigma_df.xtda_sigma_df(dataclasses.replace(data, packed=True))


def test_cast_to_f32_matches_jax():
    """``cast_df_data`` to f32, with the rho_floor masking that f32 GGA
    needs, in both packages: the f32 matvecs agree to f32 precision."""
    jdata = jax_sigma_df.build_df_data(jax_make_reference(jax_load_mf(CKPT, df=True)))
    data = sigma_df.build_df_data(make_reference(
        load_mf(CKPT, df=True, device="cpu", dtype=torch.float64)))
    jop = jax_sigma_df.xtda_sigma_df(jax_sigma_df.cast_df_data(jdata, np.float32))
    data32 = sigma_df.cast_df_data(data, torch.float32)
    assert float((data32.grid_w == 0).sum()) == float((np.asarray(
        jax_sigma_df.cast_df_data(jdata, np.float32).grid_w) == 0).sum())
    op = sigma_df.xtda_sigma_df(data32)
    z = np.random.default_rng(2).normal(size=(NZ, op.dim)).astype(np.float32)
    got = op.matvec(torch.as_tensor(z))
    assert got.dtype == torch.float32
    _rel_close(got.numpy(), np.asarray(jop.matvec(z)), rtol=1e-4)

"""Host layer of the port (integrals, DF metric, grid, AO values) against the
JAX package's arrays on FH/6-31G, to 1e-12 absolute.

The one exception is what follows the inverse square root of the fit metric.
The port builds the integral engine from source without ``-march=native``,
so its 2-center metric differs from the JAX package's prebuilt engine by a
few ulps (~1e-14); the metric's condition number (~3e8 here) amplifies that
to ~1e-8 relative in metric^-1/2.  So the metric itself is held to 1e-12,
the port's metric^-1/2 recipe is held exactly to the JAX recipe on the same
metric, and the two packages' metric^-1/2 and B are held to that
conditioning-scaled tolerance."""

import pathlib

import numpy as np
import pytest
import torch

from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu_torch.scf.checkpoint import load_mf as torch_load_mf

CKPT = str(pathlib.Path(__file__).parent / "data" / "fh_entry_ckpt.npz")
ATOL = 1e-12


@pytest.fixture(scope="module")
def envs():
    jenv = jax_load_mf(CKPT, df=True).env
    tenv = torch_load_mf(CKPT, df=True, device="cpu", dtype=torch.float64).env
    return jenv, tenv


def _close(a, b):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)


def test_sizes(envs):
    jenv, tenv = envs
    assert tenv.nao == jenv.nao
    assert tenv.aux_layout.nao == jenv.aux_layout.nao
    assert tenv.grid.size == jenv.grid.size


@pytest.mark.parametrize("name", ["S", "hcore", "dip", "ipovlp", "rxp",
                                  "grid_weights", "ao"])
def test_device_tensors(envs, name):
    jenv, tenv = envs
    _close(getattr(jenv, name), getattr(tenv, name))


def test_df_j3c(envs):
    jenv, tenv = envs
    _close(jenv.df_j3c_host(), tenv.df_j3c_host())


def test_df_metric(envs):
    from xtddft_tpu.ints.two_electron import eri_2c as jax_eri_2c
    from xtddft_tpu_torch.ints.two_electron import eri_2c

    jenv, tenv = envs
    _close(jax_eri_2c(jenv.aux_layout), eri_2c(tenv.aux_layout))


def test_df_isqrt(envs):
    """The port's metric^-1/2 is exactly the JAX recipe on the port's own
    metric, and within the conditioning-scaled tolerance of the JAX one."""
    from xtddft_tpu_torch.ints.two_electron import eri_2c

    jenv, tenv = envs
    w, U = np.linalg.eigh(eri_2c(tenv.aux_layout))
    keep = w > 1e-10
    recipe = (U[:, keep] / np.sqrt(w[keep])[None, :]) @ U[:, keep].T
    _close(recipe, tenv.df_isqrt_host())
    ref = jenv.df_isqrt_host()
    np.testing.assert_allclose(tenv.df_isqrt_host(), ref, rtol=0,
                               atol=1e-7 * np.abs(ref).max())


def test_df_B(envs):
    jenv, tenv = envs
    ref = jenv.df_B_host()
    np.testing.assert_allclose(tenv.df_B().numpy(), ref, rtol=0,
                               atol=1e-9 * np.abs(ref).max())

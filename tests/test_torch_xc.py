"""The port's fxc response (torch.func jvp of grad) against the JAX one on
numpy-made grid points, f64, to relative 1e-10 of each output's scale."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xtddft_tpu.xc import interface as jax_xci
from xtddft_tpu.xc import registry as jax_registry
from xtddft_tpu_torch.xc import interface as xci
from xtddft_tpu_torch.xc import registry

NPTS, NZ = 300, 3
RTOL = 1e-10


@pytest.fixture(scope="module")
def grid_sample():
    rng = np.random.default_rng(7)
    ra = rng.uniform(1e-4, 2.0, NPTS)
    rb = ra * rng.uniform(0.2, 1.0, NPTS)
    ga = 0.3 * rng.normal(size=(3, NPTS))
    gb = 0.3 * rng.normal(size=(3, NPTS))
    # a few sanitized points (negligible density), as real grids have
    ra[:5] = rb[:5] = 1e-14
    w = rng.uniform(0.01, 1.0, NPTS)
    drho = (rng.normal(size=(NZ, NPTS)), rng.normal(size=(NZ, NPTS)),
            rng.normal(size=(NZ, 3, NPTS)), rng.normal(size=(NZ, 3, NPTS)))
    return w, (ra, rb, ga, gb), drho


@pytest.mark.parametrize("name", ["svwn", "blyp", "b3lyp", "bhandhlyp", "pbe0"])
def test_fxc_jvp_matches_jax(grid_sample, name):
    w, rho, drho = grid_sample

    jw, jrho, jmask = jax_xci._sanitize(jnp.asarray(w), tuple(map(jnp.asarray, rho)))
    jresp = jax_xci.make_fxc_jvp(jax_registry.resolve(name))
    jd = tuple(jnp.asarray(d) for d in drho)
    want = jax.vmap(lambda d: jresp(jw, jrho, d))(jd)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    tw, trho, tmask = xci._sanitize(t(w), tuple(map(t, rho)))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    resp = xci.make_fxc_jvp(registry.resolve(name))
    got = torch.func.vmap(lambda d: resp(tw, trho, d))(tuple(map(t, drho)))

    for g, wv in zip(got, want):
        wv = np.asarray(wv)
        g = g.numpy()
        assert np.all(np.isfinite(g))
        scale = max(np.abs(wv).max(), 1e-300)
        np.testing.assert_allclose(g, wv, rtol=0, atol=RTOL * scale)


def test_rho_on_grid_matches_jax():
    rng = np.random.default_rng(3)
    ao = rng.normal(size=(4, 200, 12))
    c = rng.normal(size=(12, 4))
    dm = c @ c.T
    jr, jg = jax_xci.cache_rho(jnp.asarray(ao), jnp.asarray(dm))
    tr, tg = xci.cache_rho(torch.as_tensor(ao), torch.as_tensor(dm))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jg)).max())

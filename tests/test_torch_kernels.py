"""Kernels K1-K3 of the port.

Each kernel's plain torch version against the JAX einsums it replaces
(`xtddft_tpu/response/sigma_df.py` :424-426, :496-508, :526-534) on random
inputs, f64, to relative 1e-12.  The CUDA kernels themselves are held
against these plain versions in `test_torch_kernels_gpu.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xtddft_tpu_torch.kernels import df_exchange as k1
from xtddft_tpu_torch.kernels import grid_back as k3
from xtddft_tpu_torch.kernels import grid_rho1 as k2

NAUX, NMO, GC, NZ = 64, 40, 256, 3
NOCC = 11
RTOL = 1e-12


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(NAUX, NMO, NMO))
    B = 0.5 * (B + B.transpose(0, 2, 1))
    z = rng.normal(size=(NZ, NOCC, NMO - NOCC))
    phi = rng.normal(size=(4, GC, NMO))
    mask = rng.uniform(size=GC) > 0.1
    dwv = rng.normal(size=(NZ, GC))
    dwg = rng.normal(size=(NZ, 3, GC))
    return B, z, phi, mask, dwv, dwg


def _rel_close(got, want, rtol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _jax_jk(B, z, o, v):
    """`sigma_df.py:424-426`, one aux chunk of all of naux."""
    Bc = jnp.asarray(B)
    z = jnp.asarray(z)
    t = jnp.einsum("Pjb,xjb->xP", Bc[:, o, v], z)
    T = jnp.einsum("Pab,xjb->xPja", Bc[:, v, v], z)
    K = jnp.einsum("Pji,xPja->xia", Bc[:, o, o], T)
    return t, K


def _jax_rho1(z, o, v, p0, p1, mask):
    """`sigma_df.py:496-508` (GGA branch)."""
    tmp = jnp.einsum("xov,gv->xgo", z, p0[:, v])
    r = jnp.einsum("xgo,go->xg", tmp, p0[:, o])
    g = jnp.einsum("xgo,ygo->xyg", tmp, p1[:, :, o])
    tmp2 = jnp.einsum("xov,ygv->xygo", z, p1[:, :, v])
    g = g + jnp.einsum("xygo,go->xyg", tmp2, p0[:, o])
    return jnp.where(mask[None], r, 0.0), jnp.where(mask[None, None], g, 0.0)


def _jax_back(dwv, dwg, o, v, p0, p1):
    """`sigma_df.py:526-534` (GGA branch)."""
    tmp = jnp.einsum("xg,go->xgo", dwv, p0[:, o])
    tmp = tmp + jnp.einsum("xyg,ygo->xgo", dwg, p1[:, :, o])
    r = jnp.einsum("xgo,gv->xov", tmp, p0[:, v])
    tmp2 = jnp.einsum("xyg,go->xygo", dwg, p0[:, o])
    return r + jnp.einsum("xygo,ygv->xov", tmp2, p1[:, :, v])


@pytest.mark.parametrize("chunk", [None, 16])
def test_df_exchange_plain_matches_jax(chunk):
    B, z, *_ = _inputs()
    o, v = slice(0, NOCC), slice(NOCC, None)
    t_want, K_want = _jax_jk(B, z, o, v)
    t, K = k1.df_exchange(torch.as_tensor(B), torch.as_tensor(z), 0, NOCC, chunk)
    _rel_close(t, t_want, RTOL)
    _rel_close(K, K_want, RTOL)


def test_grid_rho1_plain_matches_jax():
    _, z, phi, mask, *_ = _inputs(1)
    o, v = slice(0, NOCC), slice(NOCC, None)
    r_want, g_want = _jax_rho1(jnp.asarray(z), o, v, jnp.asarray(phi[0]),
                               jnp.asarray(phi[1:4]), jnp.asarray(mask))
    out = k2.grid_rho1(torch.as_tensor(phi), torch.as_tensor(z), 0, NOCC,
                       torch.as_tensor(mask, dtype=torch.float64))
    _rel_close(out[:, 0], r_want, RTOL)
    _rel_close(out[:, 1:4], g_want, RTOL)


def test_grid_back_plain_matches_jax():
    _, _, phi, _, dwv, dwg = _inputs(2)
    o, v = slice(0, NOCC), slice(NOCC, None)
    want = _jax_back(jnp.asarray(dwv), jnp.asarray(dwg), o, v,
                     jnp.asarray(phi[0]), jnp.asarray(phi[1:4]))
    acc = torch.full((NZ, NOCC, NMO - NOCC), 0.5, dtype=torch.float64)
    out = k3.grid_back(torch.as_tensor(dwv), torch.as_tensor(dwg),
                       torch.as_tensor(phi), 0, NOCC, acc)
    assert out is acc  # accumulates in place
    _rel_close(out - 0.5, want, RTOL)

"""The whole slice through the public entry point, in both packages:
``XTDA(load_mf(fh_entry_ckpt.npz, df=True), nstates=5, backend="df").kernel()``."""

import pathlib

import numpy as np
import pytest
import torch

from xtddft_tpu.methods.drivers import XTDA as JaxXTDA
from xtddft_tpu.scf.checkpoint import load_mf as jax_load_mf
from xtddft_tpu_torch.methods.drivers import XTDA
from xtddft_tpu_torch.scf.checkpoint import load_mf

CKPT = str(pathlib.Path(__file__).parent / "data" / "fh_entry_ckpt.npz")


@pytest.fixture(scope="module")
def results():
    want = JaxXTDA(jax_load_mf(CKPT, df=True), nstates=5, backend="df").kernel()
    got = XTDA(load_mf(CKPT, df=True, device="cpu", dtype=torch.float64),
               nstates=5, backend="df").kernel()
    return got, want


def test_energies(results):
    got, want = results
    assert got.converged and want.converged
    np.testing.assert_allclose(got.e_eV, want.e_eV, rtol=0, atol=1e-6)


def test_oscillator_strengths(results):
    got, want = results
    np.testing.assert_allclose(np.abs(got.osc), np.abs(want.osc), rtol=0, atol=1e-6)


def test_rotatory_strengths(results):
    got, want = results
    np.testing.assert_allclose(np.abs(got.rot), np.abs(want.rot), rtol=0, atol=1e-6)


def test_delta_s2(results):
    got, want = results
    np.testing.assert_allclose(got.ds2, want.ds2, rtol=0, atol=1e-6)


def test_other_backends_raise():
    mf = load_mf(CKPT, df=True, device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        XTDA(mf, nstates=2, backend="dense").kernel()

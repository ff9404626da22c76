"""The CUDA kernels K1-K3 against their plain torch versions, on a GPU.

f64 to relative 1e-11 and f32 to 1e-4 of the largest entry (the summation
order differs).  Skips without a card.  The machine with the card has no
JAX, so this file imports none; run it there without the repository's
conftest (which imports the JAX package):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from xtddft_tpu_torch.kernels import df_exchange as k1
from xtddft_tpu_torch.kernels import grid_back as k3
from xtddft_tpu_torch.kernels import grid_rho1 as k2

# (naux, nmo, nocc, nz, gc): a small case, the TTM alpha block, and the
# largest nocc K1 takes (16 rows per thread)
SHAPES = [(64, 40, 11, 3, 256), (4412, 182, 137, 10, 4096), (48, 300, 256, 2, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_close(got, want, rtol):
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=["small", "ttm", "max_nocc"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_kernels_match_plain(cuda, shape, dtype, rtol):
    naux, nmo, nocc, nz, gc = shape
    g = torch.Generator(cuda).manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    B = randn(naux, nmo, nmo)
    B = 0.5 * (B + B.transpose(1, 2))
    z = randn(nz, nocc, nmo - nocc)
    # the grid chunk as the sigma sees it: a strided view of a wider table
    table = randn(4, gc + 64, nmo)
    phi = table[:, 32:32 + gc]
    mask = (torch.rand(gc, generator=g, device=cuda) > 0.1).to(dtype)
    dwv, dwg = randn(nz, gc), randn(nz, 3, gc)

    t, K = k1.df_exchange(B, z, 0, nocc)
    tp, Kp = k1.df_exchange_plain(B, z, 0, nocc)
    _rel_close(t, tp, rtol)
    _rel_close(K, Kp, rtol)
    _rel_close(k2.grid_rho1(phi, z, 0, nocc, mask),
               k2.grid_rho1_plain(phi, z, 0, nocc, mask), rtol)
    acc = randn(nz, nocc, nmo - nocc)
    _rel_close(k3.grid_back(dwv, dwg, phi, 0, nocc, acc.clone()),
               k3.grid_back_plain(dwv, dwg, phi, 0, nocc, acc.clone()), rtol)
    torch.cuda.synchronize()


def test_cpu_tensors_take_the_plain_version():
    """A wrapper given CPU tensors runs its plain version and counts no launch."""
    rng = np.random.default_rng(0)
    B = torch.as_tensor(rng.normal(size=(8, 10, 10)))
    z = torch.as_tensor(rng.normal(size=(2, 3, 7)))
    before = k1.launches
    t, K = k1.df_exchange(B, z, 0, 3)
    tp, Kp = k1.df_exchange_plain(B, z, 0, 3)
    assert k1.launches == before
    assert torch.equal(t, tp) and torch.equal(K, Kp)

"""The frozen input generator: shapes, symmetry, positive densities, the
seed's reach, and the checkpoint's Fock matrices."""

import json

import numpy as np
import pytest
import torch
from bench_tiny import tiny_checkpoint

from xbench import inputs

CFG = json.loads((inputs.REPO / "benchmark/configs/ttmdzp-b3lyp-f32.json").read_text())


def tiny(**kw):
    cfg = dict(CFG, nc=5, no=1, nv=9, naux=300, ngrid=64, **kw)
    path, sha = tiny_checkpoint(CFG["fock"]["path"], cfg["nc"], cfg["no"], cfg["nv"])
    return dict(cfg, fock=dict(CFG["fock"], path=path, sha256=sha))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_shapes_symmetry_and_density(dtype):
    inp = inputs.make_inputs(tiny(dtype=dtype), 2**31 + 11, "cpu")
    nmo = 15
    assert inp.B.shape == (300, nmo, nmo) and inp.B.dtype == inputs.DTYPES[dtype]
    assert inp.phi.shape == (4, 64, nmo) and inp.grid_w.shape == (64,)
    # B_P = G_P G_P^T: symmetric, positive semi-definite
    assert torch.equal(inp.B, inp.B.transpose(1, 2))
    ev = torch.linalg.eigvalsh(inp.B[:4].double())
    assert ev.min() > -1e-5 * ev.max()
    ra, rb, ga, gb = inp.rho0
    assert ra.shape == rb.shape == (64,) and ga.shape == gb.shape == (3, 64)
    assert (ra > 0).all() and (rb > 0).all() and (inp.grid_w > 0).all()
    # the alpha density holds every beta orbital and the open shell
    assert (ra >= rb).all()
    # each orbital normalised on the quadrature: the density counts the electrons
    tol = 1e-4 if dtype == "float32" else 1e-10
    assert abs(float(inp.grid_w @ ra) - 6) < tol and abs(float(inp.grid_w @ rb) - 5) < tol
    assert inp.fock_mo.shape == inp.fock_hf_mo.shape == (2, nmo, nmo)
    # the checkpoint's C^T F C: symmetric to its rounding
    assert np.allclose(inp.fock_mo[0], inp.fock_mo[0].T, rtol=0, atol=1e-7)
    assert np.array_equal(inp.fock_hf_mo[1], inp.fock_hf_mo[1].T)
    assert 0 < np.abs(inp.fock_hf_mo - inp.fock_mo).max() < 0.01


def test_seed_reaches_the_tensors_and_not_the_fock():
    a = inputs.make_inputs(tiny(), 5, "cpu")
    b = inputs.make_inputs(tiny(), 5, "cpu")
    c = inputs.make_inputs(tiny(), 6, "cpu")
    assert torch.equal(a.B, b.B) and torch.equal(a.phi, b.phi)
    assert not torch.equal(a.B, c.B)
    assert np.array_equal(a.fock_mo, c.fock_mo) and np.array_equal(a.fock_hf_mo, c.fock_hf_mo)


def test_checkpoint_fock_is_pinned():
    f = CFG["fock"]
    fock = inputs.checkpoint_fock(f["path"], f["sha256"], CFG["nc"], CFG["no"], CFG["nv"])
    assert fock.shape == (2, 598, 598)
    e = np.diag(fock[0])
    # core below the open shell below the virtuals, as the ROKS reference orders them
    assert e[:136].max() < e[136] < e[137:].min()
    with pytest.raises(RuntimeError, match="sha256"):
        inputs.checkpoint_fock(f["path"], "0" * 64, CFG["nc"], CFG["no"], CFG["nv"])
    with pytest.raises(RuntimeError, match="configuration"):
        inputs.checkpoint_fock(f["path"], f["sha256"], 135, 2, 461)

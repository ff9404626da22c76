"""The CUDA kernels K1-K5, every mode, against their plain torch versions, on a GPU.

f64 to relative 1e-11 and f32 to 1e-4 of the largest entry (the summation
order differs); the SCF's fixed-order modes also repeat bitwise.  Skips without a card.  The machine with the card has no
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
from xtddft_tpu_torch.kernels import eri_grad as k5
from xtddft_tpu_torch.kernels import stda_coupling as k4

# (naux, nmo, nocc, nz, gc), nvir = nmo - nocc
SHAPES = {
    "small": (64, 40, 11, 3, 256),
    "ttm": (4412, 182, 137, 10, 4096),
    "nocc256": (48, 300, 256, 2, 512),
    "nocc300": (48, 340, 300, 2, 512),
    "nz1": (96, 120, 30, 1, 256),
    "nvir10": (100, 60, 50, 2, 256),  # nvir below one 16-wide k step
    "odd": (257, 64, 21, 3, 300),  # odd naux, odd grid span
    "bench": (2000, 1000, 80, 20, 4096),  # the bench operator's alpha block
    "ttm_span": (256, 182, 137, 10, 23 * 4096),  # K3 on one jvp group of TTM
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_close(got, want, rtol):
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_kernels_match_plain(cuda, shape, dtype, rtol):
    naux, nmo, nocc, nz, gc = shape
    g = torch.Generator(cuda).manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    B = randn(naux, nmo, nmo)
    B = (B + B.transpose(1, 2)).mul_(0.5)
    z = randn(nz, nocc, nmo - nocc)
    # the grid chunk as the sigma sees it: a strided view of a wider table
    table = randn(4, gc + 64, nmo)
    phi = table[:, 32:32 + gc]
    mask = (torch.rand(gc, generator=g, device=cuda) > 0.1).to(dtype)
    dwv, dwg = randn(nz, gc), randn(nz, 3, gc)

    t, K = k1.df_exchange(B, z, 0, nocc)
    tp, Kp = k1.df_exchange_plain(B, z, 0, nocc, 64)
    _rel_close(t, tp, rtol)
    _rel_close(K, Kp, rtol)
    del B, t, K, tp, Kp
    _rel_close(k2.grid_rho1(phi, z, 0, nocc, mask),
               k2.grid_rho1_plain(phi, z, 0, nocc, mask), rtol)
    acc = randn(nz, nocc, nmo - nocc)
    _rel_close(k3.grid_back(dwv, dwg, phi, 0, nocc, acc.clone()),
               k3.grid_back_plain(dwv, dwg, phi, 0, nocc, acc.clone()), rtol)
    torch.cuda.synchronize()


# spin-flip modes: (naux, nmo, n_o, v0, n_v, nz, gc); o = [0, n_o), v = [v0, v0 + n_v)
FLIP_SHAPES = {
    "small_overlap": (64, 40, 13, 9, 31, 3, 300),  # v0 inside the occupied range, off a run
    "ttm_down": (512, 182, 137, 136, 46, 10, 8192),
    "ttm_up": (512, 182, 136, 137, 45, 10, 8192),
    "bench_down": (128, 1000, 80, 78, 922, 4, 4096),
    "nv_below_tile": (100, 60, 50, 55, 5, 2, 256),
    "nz1": (96, 120, 30, 27, 93, 1, 256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True], ids=["one_table", "two_tables"])
@pytest.mark.parametrize("shape", list(FLIP_SHAPES.values()), ids=list(FLIP_SHAPES))
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_flip_modes_match_plain(cuda, shape, two, dtype, rtol):
    """Exchange-only K1 and value-only / four-component K2 and K3 on
    overlapping o/v ranges, with the virtual side on the same or on a
    second tensor and table."""
    naux, nmo, n_o, v0, n_v, nz, gc = shape
    g = torch.Generator(cuda).manual_seed(1)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    def sym(*s):
        B = randn(*s)
        return (B + B.transpose(1, 2)).mul_(0.5)

    B = sym(naux, nmo, nmo)
    Bv = sym(naux, nmo, nmo) if two else None
    z = randn(nz, n_o, n_v)
    t, K = k1.df_exchange(B, z, 0, v0, B_vir=Bv, with_t=False)
    tp, Kp = k1.df_exchange_plain(B, z, 0, v0, 64, B_vir=Bv, with_t=False)
    assert t is None and tp is None
    _rel_close(K, Kp, rtol)
    del B, Bv, K, Kp
    table = randn(4, gc + 64, nmo)
    phi = table[:, 32:32 + gc]
    phi_v = randn(4, gc, nmo) if two else None
    mask = (torch.rand(gc, generator=g, device=cuda) > 0.1).to(dtype)
    dwv, dwg = randn(nz, gc), randn(nz, 3, gc)
    for ncomp, m in ((1, None), (4, mask), (4, None)):
        _rel_close(k2.grid_rho1(phi, z, 0, v0, m, phi_v=phi_v, ncomp=ncomp),
                   k2.grid_rho1_plain(phi, z, 0, v0, m, phi_v=phi_v, ncomp=ncomp), rtol)
    acc = randn(nz, n_o, n_v)
    for dg in (None, dwg):
        _rel_close(k3.grid_back(dwv, dg, phi, 0, v0, acc.clone(), phi_v=phi_v),
                   k3.grid_back_plain(dwv, dg, phi, 0, v0, acc.clone(), phi_v=phi_v), rtol)
    # the value row alone of a table is enough for the value-only modes
    p0 = phi[:1]
    _rel_close(k3.grid_back(dwv, None, p0, 0, v0, acc.clone()),
               k3.grid_back_plain(dwv, None, p0, 0, v0, acc.clone()), rtol)
    torch.cuda.synchronize()


# K2 at the edges of its tiles: (nmo, nocc, o0, v0, nvir, nz, gc, second
# table, the table's first point); o = [o0, o0 + nocc), v = [v0, v0 + nvir)
K2_EDGES = {
    "ragged_tiles": (220, 70, 0, 70, 150, 3, 1000, False, 0),  # nocc, nvir, gc off the tiles
    "nvir_below_kstep": (60, 50, 0, 55, 5, 2, 300, False, 0),  # nvir < one 16-wide k step
    "one_vector": (120, 30, 0, 30, 90, 1, 513, False, 0),
    "points_ragged": (64, 21, 0, 21, 43, 3, 4099, False, 0),
    "overlap_two_tables": (75, 30, 0, 27, 48, 4, 700, True, 0),
    "shifted_both": (80, 13, 3, 17, 61, 3, 257, True, 0),  # o0 and v0 off a 16-byte run
    "many_vectors": (40, 3, 0, 3, 37, 50, 260, False, 0),  # 4-row vectors, many per row tile
    "unaligned_table": (183, 60, 0, 61, 122, 5, 640, True, 1),  # element copies: odd nmo, start
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(K2_EDGES.values()), ids=list(K2_EDGES))
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_grid_rho1_edges(cuda, shape, dtype, rtol):
    """K2's two GEMMs and tile epilogues at ragged and degenerate extents,
    with and without mask, value-only and four-component."""
    nmo, nocc, o0, v0, nvir, nz, gc, two, g0 = shape
    g = torch.Generator(cuda).manual_seed(2)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    phi = randn(4, g0 + gc + 8, nmo)[:, g0:g0 + gc]
    phi_v = randn(4, gc + 8, nmo)[:, g0:g0 + gc] if two else None
    z = randn(nz, nocc, nvir)
    mask = (torch.rand(gc, generator=g, device=cuda) > 0.1).to(dtype)
    before = k2.launches
    for ncomp in (1, 4):
        for m in (None, mask):
            _rel_close(k2.grid_rho1(phi, z, o0, v0, m, phi_v=phi_v, ncomp=ncomp),
                       k2.grid_rho1_plain(phi, z, o0, v0, m, phi_v=phi_v, ncomp=ncomp), rtol)
    assert k2.launches == before + 4
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True], ids=["atomic", "fixed_order"])
@pytest.mark.parametrize("shape", list(K2_EDGES.values()), ids=list(K2_EDGES))
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_tau_modes_match_plain(cuda, shape, fixed, dtype, rtol):
    """The meta-GGA modes at K2's tile edges (ragged tiles, one vector, 4099
    points, overlapping o/v ranges with two tables): K2 with its tau row
    (``ncomp=5``), with and without mask, and K3 with its tau term
    (``dwt``), in the atomic and in the fixed order; the fixed order repeats
    bitwise."""
    nmo, nocc, o0, v0, nvir, nz, gc, two, g0 = shape
    g = torch.Generator(cuda).manual_seed(12)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    phi = randn(4, g0 + gc + 8, nmo)[:, g0:g0 + gc]
    phi_v = randn(4, gc + 8, nmo)[:, g0:g0 + gc] if two else None
    z = randn(nz, nocc, nvir)
    mask = (torch.rand(gc, generator=g, device=cuda) > 0.1).to(dtype)
    before = (k2.launches, k3.launches)
    for m in (None, mask):
        want = k2.grid_rho1_plain(phi, z, o0, v0, m, phi_v=phi_v, ncomp=5)
        got = [k2.grid_rho1(phi, z, o0, v0, m, phi_v=phi_v, ncomp=5, fixed_order=fixed)
               for _ in range(2 if fixed else 1)]
        _rel_close(got[0], want, rtol)
        if fixed:
            assert torch.equal(got[0], got[1])
    dwv, dwg, dwt = randn(nz, gc), randn(nz, 3, gc), randn(nz, gc)
    acc = randn(nz, nocc, nvir)
    want = k3.grid_back_plain(dwv, dwg, phi, o0, v0, acc.clone(), phi_v=phi_v, dwt=dwt)
    got = [k3.grid_back(dwv, dwg, phi, o0, v0, acc.clone(), phi_v=phi_v, fixed_order=fixed,
                        dwt=dwt) for _ in range(2 if fixed else 1)]
    _rel_close(got[0], want, rtol)
    if fixed:
        assert torch.equal(got[0], got[1])
    n = 2 if fixed else 1
    assert (k2.launches, k3.launches) == (before[0] + 2 * n, before[1] + n)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("nao", [37, 183])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_tau_ao_modes_match_plain(cuda, nao, dtype, rtol):
    """The meta-GGA SCF's AO modes: K2 hermitian with its tau row and K3 on
    the AO table with its tau term, fixed order (bitwise twice) and atomic,
    on a ragged 4099-point grid; and the in-core sigma's masked stack."""
    g = torch.Generator(cuda).manual_seed(13)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    gc = 4099
    c = randn(2, nao, 9)
    dms = c @ c.transpose(1, 2)
    ao = randn(4, gc, nao)
    mask = (torch.rand(gc, generator=g, device=cuda) > 0.06).to(dtype)
    for m in (None, mask):
        want = k2.grid_rho1_plain(ao, dms, 0, 0, m, ncomp=5, hermi=True)
        rho = [k2.grid_rho1(ao, dms, 0, 0, m, ncomp=5, hermi=True, fixed_order=True)
               for _ in range(2)]
        _rel_close(rho[0], want, rtol)
        assert torch.equal(rho[0], rho[1])
        _rel_close(k2.grid_rho1(ao, dms, 0, 0, m, ncomp=5, hermi=True), want, rtol)
    dwv, dwg, dwt = randn(2, gc), randn(2, 3, gc), randn(2, gc)
    out = torch.zeros((2, nao, nao), device=cuda, dtype=dtype)
    want = k3.grid_back_plain(dwv, dwg, ao, 0, 0, out.clone(), dwt=dwt)
    vm = [k3.grid_back(dwv, dwg, ao, 0, 0, out.clone(), fixed_order=True, dwt=dwt)
          for _ in range(2)]
    _rel_close(vm[0], want, rtol)
    assert torch.equal(vm[0], vm[1])
    _rel_close(k3.grid_back(dwv, dwg, ao, 0, 0, out.clone(), dwt=dwt), want, rtol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("nao", [37, 183])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_ao_modes_match_plain(cuda, nao, dtype, rtol):
    """The SCF's Fock build on the kernels: K1 in AO mode (o0 = v0 = 0, nocc =
    nvir = nao, two density matrices), K2 in its hermitian mode and K3 with
    the AO table on both sides, at odd nao (element copies of the tables in
    f32) and a ragged 4099-point grid, one launch each."""
    g = torch.Generator(cuda).manual_seed(5)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    naux, gc = 301, 4099
    B = randn(naux, nao, nao)
    B = (B + B.transpose(1, 2)).mul_(0.5)
    c = randn(2, nao, 9)
    dms = c @ c.transpose(1, 2)  # symmetric, one per spin
    ao = randn(4, gc, nao)
    dwv, dwg = randn(2, gc), randn(2, 3, gc)
    before = (k1.launches, k2.launches, k3.launches)
    t, K = k1.df_exchange(B, dms, 0, 0)
    tp, Kp = k1.df_exchange_plain(B, dms, 0, 0)
    _rel_close(t, tp, rtol)
    _rel_close(K, Kp, rtol)
    _rel_close(k2.grid_rho1(ao, dms, 0, 0, hermi=True),
               k2.grid_rho1_plain(ao, dms, 0, 0, hermi=True), rtol)
    out = torch.zeros((2, nao, nao), device=cuda, dtype=dtype)
    _rel_close(k3.grid_back(dwv, dwg, ao, 0, 0, out.clone()),
               k3.grid_back_plain(dwv, dwg, ao, 0, 0, out.clone()), rtol)
    assert (k1.launches, k2.launches, k3.launches) == tuple(n + 1 for n in before)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("nao", [11, 38, 114])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_incore_sigma_modes_match_plain(cuda, nao, dtype, rtol):
    """The in-core sigma's modes (`xc/interface.fxc_v1mat`, `sf_v1mat`): K2
    hermitian on 10 symmetrized transition matrices with a 0/1 mask, and
    K3's value term alone with the AO table on both sides, in the atomic
    order the sigma runs and in the fixed order, on a ragged 4099-point
    grid."""
    g = torch.Generator(cuda).manual_seed(11)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    nz, gc = 10, 4099
    d = randn(nz, nao, nao)
    dms = 0.5 * (d + d.transpose(1, 2))
    ao = randn(4, gc, nao)
    mask = (torch.rand(gc, generator=g, device=cuda) > 0.06).to(dtype)
    dwv = randn(nz, gc)
    before = (k2.launches, k3.launches)
    want = k2.grid_rho1_plain(ao, dms, 0, 0, mask, hermi=True)
    assert not want[:, :, mask == 0].any()
    for fixed in (False, True):
        _rel_close(k2.grid_rho1(ao, dms, 0, 0, mask, hermi=True, fixed_order=fixed), want, rtol)
    out = torch.zeros((nz, nao, nao), device=cuda, dtype=dtype)
    want = k3.grid_back_plain(dwv, None, ao, 0, 0, out.clone())
    for fixed in (False, True):
        _rel_close(k3.grid_back(dwv, None, ao, 0, 0, out.clone(), fixed_order=fixed), want, rtol)
    assert (k2.launches, k3.launches) == tuple(n + 2 for n in before)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("nao", [183, 598])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_fixed_order_ao_modes_repeat_bitwise(cuda, nao, dtype, rtol):
    """The SCF's Fock build sums in a fixed order: K1 in AO mode, K2 hermitian
    and K3 on the AO table, launched twice each on the same inputs, give the
    bitwise-same output, within the tolerance of the plain version.  At these
    sizes K1 and K3 split their reductions across blocks (18-190 output tiles
    against two waves of blocks), and K2 adds the partial densities of 3-10
    row tiles per matrix into each point."""
    g = torch.Generator(cuda).manual_seed(7)

    def randn(*s):
        return torch.randn(s, generator=g, device=cuda, dtype=dtype)

    naux, gc = 301, 4099
    B = randn(naux, nao, nao)
    B = (B + B.transpose(1, 2)).mul_(0.5)
    c = randn(2, nao, 9)
    dms = c @ c.transpose(1, 2)
    ao = randn(4, gc, nao)
    dwv, dwg = randn(2, gc), randn(2, 3, gc)
    before = (k1.launches, k2.launches, k3.launches)
    runs = [k1.df_exchange(B, dms, 0, 0) for _ in range(2)]
    tp, Kp = k1.df_exchange_plain(B, dms, 0, 0)
    for t, K in runs:
        _rel_close(t, tp, rtol)
        _rel_close(K, Kp, rtol)
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    del B, runs, tp, Kp
    rho = [k2.grid_rho1(ao, dms, 0, 0, hermi=True, fixed_order=True) for _ in range(2)]
    _rel_close(rho[0], k2.grid_rho1_plain(ao, dms, 0, 0, hermi=True), rtol)
    assert torch.equal(rho[0], rho[1])
    out = torch.zeros((2, nao, nao), device=cuda, dtype=dtype)
    vm = [k3.grid_back(dwv, dwg, ao, 0, 0, out.clone(), fixed_order=True) for _ in range(2)]
    _rel_close(vm[0], k3.grid_back_plain(dwv, dwg, ao, 0, 0, out.clone()), rtol)
    assert torch.equal(vm[0], vm[1])
    assert (k1.launches, k2.launches, k3.launches) == tuple(n + 2 for n in before)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_k1_at_the_dzp_main_shape(cuda, dtype, rtol):
    """K1's X-TDA mode at the TTM/dzp alpha block (naux 3990, nmo 598, nocc
    137, nvir 461, 20 trial vectors: 11.4 GB of B in f64), in several aux
    chunks of its T buffer, against the plain version; K1 sums in its fixed
    order in every mode, so a second launch repeats the first bitwise."""
    g = torch.Generator(cuda).manual_seed(8)
    naux, nmo, nocc, nz = 3990, 598, 137, 20
    G = torch.randn((naux, nmo, 8), generator=g, device=cuda, dtype=dtype)
    B = torch.bmm(G, G.transpose(1, 2)) / (naux * nmo * 8) ** 0.5
    del G
    z = torch.randn((nz, nocc, nmo - nocc), generator=g, device=cuda, dtype=dtype)
    assert k1.plan_aux_chunk(naux, nz, nocc, nmo - nocc, z.element_size()) < naux
    t, K = k1.df_exchange(B, z, 0, nocc)
    t2, K2 = k1.df_exchange(B, z, 0, nocc)
    assert torch.equal(t, t2) and torch.equal(K, K2)
    del t2, K2
    tp, Kp = k1.df_exchange_plain(B, z, 0, nocc)
    _rel_close(t, tp, rtol)
    _rel_close(K, Kp, rtol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_scf_on_the_card_matches_the_cpu(cuda):
    """The SCF whose Fock builds run on K1, K2 and K3 (FH ROKS/BHandHLYP,
    6-31G, DF, grid level 1) converges to the CPU run's state (the plain
    versions), one launch of each kernel per Fock build."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.scf import ROKS

    mol = Molecule.from_atoms("F 0 0 0; H 0 0 1.0", basis="6-31g", spin=2)
    want = ROKS(mol, xc="bhandhlyp", grid_level=1, df=True, device="cpu").kernel()
    scf = ROKS(mol, xc="bhandhlyp", grid_level=1, df=True)
    kernels.reset_launch_counts()
    got = scf.kernel()
    assert got.converged and want.converged
    assert abs(got.e_tot - want.e_tot) <= 1e-9
    np.testing.assert_allclose(got.mo_energy, want.mo_energy, rtol=0, atol=1e-7)
    counts = kernels.launch_counts()
    assert {m.NAME: counts[m.NAME] for m in kernels.DF_MODULES} == {
        m.NAME: scf.cycles for m in kernels.DF_MODULES}
    assert counts["stda_coupling"] == 0


@pytest.mark.cuda
def test_cuda_wrappers_refuse_empty_extents(cuda):
    """No kernel is launched on an empty extent: the wrappers raise."""
    B = torch.zeros((4, 6, 6), device=cuda, dtype=torch.float64)
    phi = torch.zeros((4, 8, 6), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        k1.df_exchange(B, torch.zeros((2, 3, 0), device=cuda, dtype=torch.float64), 0, 3,
                       with_t=False)
    with pytest.raises(ValueError):
        k2.grid_rho1(phi, torch.zeros((0, 3, 3), device=cuda, dtype=torch.float64), 0, 3)
    with pytest.raises(ValueError):
        k3.grid_back(torch.zeros((2, 8), device=cuda, dtype=torch.float64), None, phi, 0, 3,
                     torch.zeros((2, 0, 3), device=cuda, dtype=torch.float64))


# the RPA exchange: (naux, nmo, o0, nocc, v0, nvir, nz)
RPA_SHAPES = {
    "ttm_a": (4412, 182, 0, 137, 137, 45, 20),  # nvir < nocc: the JAX order
    "ttm_b": (4412, 182, 0, 136, 136, 46, 20),
    "square": (96, 80, 0, 40, 40, 40, 3),  # nocc = nvir
    "nz1": (96, 120, 0, 30, 30, 90, 1),  # one vector, nocc < nvir
    "nocc300": (48, 340, 0, 300, 300, 40, 2),
    "nvir300": (48, 340, 0, 40, 40, 300, 2),
    "ragged": (257, 77, 3, 21, 29, 45, 3),  # offsets off a run, odd naux
    "bench": (2000, 1000, 0, 80, 80, 920, 20),
    "nocc1": (65, 40, 0, 1, 1, 39, 3),  # one occupied orbital
    "nvir1": (65, 40, 0, 39, 39, 1, 3),  # one virtual
    "nmo2mod4": (131, 182, 0, 137, 137, 45, 1),  # f32 rows of 182: 2 mod 4; nz 1
    "vo_wide": (67, 300, 0, 250, 250, 50, 4),  # nocc >= nvir with several tiles of both
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(RPA_SHAPES.values()), ids=list(RPA_SHAPES))
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-11), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_rpa_exchange_matches_plain(cuda, shape, dtype, rtol):
    """K1's RPA exchange in the order the shape picks, on the aligned copy of
    the block, against the plain version, aux-chunked (a chunk of 64 and
    the default), both row tiles of each GEMM, and repeating bitwise."""
    naux, nmo, o0, nocc, v0, nvir, nz = shape
    g = torch.Generator(cuda).manual_seed(1)
    B = torch.randn((naux, nmo, nmo), generator=g, device=cuda, dtype=dtype)
    B = (B + B.transpose(1, 2)).mul_(0.5)
    z = torch.randn((nz, nocc, nvir), generator=g, device=cuda, dtype=dtype)
    R = k1.rpa_aligned(B, o0, nocc, v0, nvir)
    before = k1.mode_launches["rpa_exchange"]
    for chunk in (64, None):
        want = k1.rpa_exchange_plain(B, z, o0, v0, chunk)
        for tiles in ((0, 0), (64, 128), (128, 64)):
            v = k1.rpa_exchange(B, z, o0, v0, chunk, aligned=R, tiles=tiles)
            _rel_close(v, want, rtol)
            assert torch.equal(v, k1.rpa_exchange(B, z, o0, v0, chunk, aligned=R, tiles=tiles))
    assert k1.mode_launches["rpa_exchange"] == before + 12
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_rpa_aligned_copy(cuda, dtype):
    """The aligned copy holds the block (or its transpose), its pad is zero,
    and the kernel refuses a copy of another block."""
    g = torch.Generator(cuda).manual_seed(2)
    B = torch.randn((9, 40, 40), generator=g, device=cuda, dtype=dtype)
    for nocc, nvir in ((7, 33), (33, 7)):
        R = k1.rpa_aligned(B, 0, nocc, nocc, nvir)
        blk = B[:, :nocc, nocc:nocc + nvir]
        want = blk if nocc < nvir else blk.transpose(1, 2)
        assert torch.equal(R[:, :, :want.shape[2]], want)
        assert R.shape[2] * R.element_size() % 16 == 0
        assert not R[:, :, want.shape[2]:].any()
        z = torch.randn((2, nocc, nvir), generator=g, device=cuda, dtype=dtype)
        with pytest.raises(ValueError):
            k1.rpa_exchange(B, z[:, :-1], 0, nocc, aligned=R)


@pytest.mark.cuda
def test_rpa_exchange_rsh_pair(cuda):
    """The paired DF sigma's B half on the card with an RSH's long-range
    tensor: four RPA launches a build (both spins, B and B_lr), and the
    long-range part of B z equal to the plain version's -hyb_lr (ib|ja)
    z_jb over B_lr."""
    import dataclasses

    from xtddft_tpu_torch.response import sigma_df

    data = sigma_df.synthetic_df_data(nmo=40, nc=9, no=2, naux=70, ngrid=512, device="cuda",
                                      dtype=torch.float64)
    g = torch.Generator(cuda).manual_seed(3)
    noise = 1e-3 * torch.randn(tuple(data.B.shape), generator=g, device=cuda,
                               dtype=torch.float64)
    B_lr = 0.6 * data.B + noise + noise.transpose(1, 2)
    z = torch.randn((3, 11 * 29 + 9 * 31), generator=g, device=cuda, dtype=torch.float64)
    before = k1.mode_launches["rpa_exchange"]
    with_lr = sigma_df.xtda_sigma_df(dataclasses.replace(data, B_lr=B_lr, hyb_lr=0.3),
                                     with_b=True).matvec(z)[1]
    assert k1.mode_launches["rpa_exchange"] == before + 4
    short = sigma_df.xtda_sigma_df(data, with_b=True).matvec(z)[1]
    za, zb = z[:, :11 * 29].reshape(3, 11, 29), z[:, 11 * 29:].reshape(3, 9, 31)
    want = -0.3 * torch.cat([k1.rpa_exchange_plain(B_lr, za, 0, 11).reshape(3, -1),
                             k1.rpa_exchange_plain(B_lr, zb, 0, 9).reshape(3, -1)], dim=1)
    _rel_close(with_lr - short, want, 1e-10)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_stda_coupling_edges(cuda, dtype, rtol):
    """K4 against its plain version on device lists: TTM-like tables with a
    full block, one row, repeated indices, and the diagonal; the block
    subtracted in place from a strided view of a larger matrix; an empty
    list launches nothing; an out-of-range list raises where it is made."""
    rng = np.random.default_rng(3)
    natm, nocc, nvir = 34, 73, 46
    g = torch.as_tensor(rng.normal(size=(natm, nocc, nocc)), dtype=dtype, device=cuda)
    qv = torch.as_tensor(rng.normal(size=(natm, nvir, nvir)), dtype=dtype, device=cuda)

    def lst(o, v):
        return k4.csf_list(o, v, nocc, nvir, cuda)

    lists = {
        "block": (rng.integers(0, nocc, 300), rng.integers(0, nvir, 300),
                  rng.integers(0, nocc, 1000), rng.integers(0, nvir, 1000)),
        "one_row": (np.array([5]), np.array([7]), rng.integers(0, nocc, 77),
                    rng.integers(0, nvir, 77)),
        "repeated": (np.full(40, 3), np.full(40, 2), np.full(33, 3), np.full(33, 2)),
    }
    for o_r, v_r, o_c, v_c in lists.values():
        lr, lc = lst(o_r, v_r), lst(o_c, v_c)
        assert lr.occ.dtype == torch.int32 and lr.occ.device.type == "cuda"
        J = k4.j_block(g, qv, lr, lc)
        _rel_close(J, k4.j_block_plain(g, qv, lr, lc), rtol)
        assert torch.equal(J, k4.j_block(g, qv, lr, lc))
        M = torch.randn((len(o_r) + 5, len(o_c) + 9), dtype=dtype, device=cuda)
        want = M.clone()
        want[2:-3, 4:-5] -= J
        k4.j_block(g, qv, lr, lc, out=M[2:-3, 4:-5])
        assert torch.equal(M, want)
        d = k4.j_diagonal(g, qv, lr)
        _rel_close(d, k4.j_diagonal_plain(g, qv, lr), rtol)
        assert torch.equal(d, k4.j_diagonal(g, qv, lr))
    before = k4.launches
    empty = lst(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    assert k4.j_block(g, qv, empty, lst(*lists["block"][2:])).shape == (0, 1000)
    assert k4.j_diagonal(g, qv, empty).shape == (0,)
    assert k4.launches == before
    # a wide virtual table
    gw = torch.as_tensor(rng.normal(size=(3, 5, 5)), dtype=dtype, device=cuda)
    qw = torch.as_tensor(rng.normal(size=(3, 400, 400)), dtype=dtype, device=cuda)
    lw = k4.csf_list(rng.integers(0, 5, 70), rng.integers(0, 400, 70), 5, 400, cuda)
    lv = k4.csf_list(rng.integers(0, 5, 300), rng.integers(0, 400, 300), 5, 400, cuda)
    _rel_close(k4.j_block(gw, qw, lw, lv), k4.j_block_plain(gw, qw, lw, lv), rtol)
    for bad in ((np.array([nocc]), np.array([0])), (np.array([0]), np.array([-1]))):
        with pytest.raises(ValueError):
            lst(*bad)
    with pytest.raises(ValueError):  # a list checked against other extents
        k4.j_block(g, qv, k4.csf_list([1], [1], nocc + 1, nvir, cuda), lst([1], [1]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("atoms,basis,omega", [
    ("O 0 0 0; H 0 0 0.96; H 0.93 0 -0.25", "sto-3g", 0.0),
    ("N 0 0 0; H 0 0 1.9", "cc-pvdz", 0.0),
    ("N 0 0 0; H 0 0 1.9", "cc-pvdz", 0.33),
], ids=["h2o_sto3g", "nh_ccpvdz", "nh_ccpvdz_lr"])
def test_eri_grad_matches_plain(cuda, atoms, basis, omega):
    """K5 against the autograd vjp of diffints' ERIs (relative 1e-12; d
    shells reach the kernel's L = 9), bitwise repeatable, counted once per
    call; a Gamma of any symmetry."""
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.ints import build_layout

    lay = build_layout(Molecule.from_atoms(atoms, basis=basis, spin=1 if "N" in atoms else 0))
    rng = np.random.default_rng(0)
    G = torch.as_tensor(rng.normal(size=(lay.nao,) * 4), device=cuda)
    before = k5.launches
    g = k5.eri_grad(lay, G, omega)
    assert k5.launches == before + 1
    _rel_close(g, k5.eri_grad_plain(lay, G, omega), 1e-12)
    assert torch.equal(g, k5.eri_grad(lay, G, omega))
    assert float(g.sum(0).abs().max()) <= 1e-12 * float(g.abs().max())


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

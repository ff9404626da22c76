"""The CUDA kernels K1-K3, every mode, against their plain torch versions, on a GPU.

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
    assert kernels.launch_counts() == {n: scf.cycles for n in kernels.launch_counts()}


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

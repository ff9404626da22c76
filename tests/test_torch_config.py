"""The port's device default and its own operation counts.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``; without a card ``config.resolve()`` raises instead of
moving to the CPU.  The card is hidden by patching
``torch.cuda.is_available`` inside each test.  ``response/flops.py`` keeps
the port's copy of the benchmark's flop count; it must equal
``bench.matvec_flops``.
"""

import pathlib

import pytest
import torch

import bench
from xtddft_tpu_torch import config
from xtddft_tpu_torch.response import flops, sigma_df
from xtddft_tpu_torch.scf.checkpoint import load_mf

CKPT = str(pathlib.Path(__file__).parent / "data" / "fh_entry_ckpt.npz")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.resolve(None, torch.float32)


def test_resolve_takes_the_cpu_when_asked(no_card):
    assert config.resolve("cpu") == (torch.device("cpu"), torch.float64)
    assert config.resolve(torch.device("cpu"), torch.float32) == (
        torch.device("cpu"), torch.float32)


def _scf():
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.scf import ROKS

    return ROKS(Molecule.from_atoms("F 0 0 0; H 0 0 1.0", basis="6-31g", spin=2),
                xc="b3lyp", grid_level=1, df=True)


ENTRY_POINTS = {
    "load_mf": lambda: load_mf(CKPT, df=True),
    "scf": _scf,
    "synthetic_df_data": lambda: sigma_df.synthetic_df_data(
        nmo=12, nc=3, no=1, naux=8, ngrid=64),
    "df_data_from_arrays": lambda: sigma_df.df_data_from_arrays({"nc": 1}, None),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_never_default_to_the_cpu(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_entry_point_runs_on_the_cpu_when_asked(no_card):
    data = sigma_df.synthetic_df_data(nmo=12, nc=3, no=1, naux=8, ngrid=64,
                                      device="cpu", dtype=torch.float64)
    assert data.B.device.type == "cpu"


# (nc, no, nv, naux, ngrid, nb): TTM/STO-3G's 11-vector block and the bench operator
SHAPES = {"ttm": (136, 1, 45, 4412, 187644, 11), "bench": (78, 2, 920, 2000, 49152, 21)}


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("hyb_terms", [1, 2])
def test_matvec_flops_is_the_benchmarks(shape, hyb_terms):
    assert flops.matvec_flops(*shape, hyb_terms=hyb_terms) == bench.matvec_flops(
        *shape, hyb_terms=hyb_terms)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_kernel_counts_add_up_to_the_sigma_count(shape):
    """K1's t, T and K terms of both spin blocks are the exchange part of
    matvec_flops (which also counts the Coulomb back-projection).  Its fxc
    part counts four phi components both ways (8 flops per vector, point
    and (o, v) pair each way); the GGA minimum of K2 and K3 is half that,
    plus terms linear in nocc and nvir."""
    nc, no, nv, naux, ngrid, nb = shape
    blocks = ((nc + no, nv), (nc, no + nv))
    k1 = sum(flops.df_exchange_flops(naux, nb, o, v) for o, v in blocks)
    back = sum(2.0 * naux * o * v * nb for o, v in blocks)
    jk = flops.matvec_flops(nc, no, nv, naux, 0, nb)
    assert k1 + back == pytest.approx(jk, rel=1e-12)
    fxc = sum(flops.grid_rho1_flops(nb, o, v, ngrid) + flops.grid_back_flops(nb, o, v, ngrid)
              for o, v in blocks)
    linear = sum(2.0 * nb * ngrid * (7 * o + 7 * v) for o, v in blocks)
    assert fxc - linear == pytest.approx(0.5 * (flops.matvec_flops(*shape) - jk), rel=1e-12)


def test_bounds_at_the_issue_shapes():
    """K1 at the bench alpha block and K3 on one chunk of TTM and bench: flop
    bound (K3 at its GGA minimum, 4*nz*nocc*nvir per point and lower terms)."""
    ms, by = flops.bound_ms(flops.df_exchange_flops(2000, 20, 80, 920),
                            flops.df_exchange_bytes(2000, 20, 80, 920, 4), "float32")
    assert by == "operations" and 87 < ms < 89
    ms, by = flops.bound_ms(flops.grid_back_flops(10, 137, 45, 4096),
                            flops.grid_back_bytes(10, 137, 45, 4096, 8), "float64")
    assert by == "operations" and 0.0155 < ms < 0.0161
    ms, by = flops.bound_ms(flops.grid_back_flops(20, 80, 920, 4096),
                            flops.grid_back_bytes(20, 80, 920, 4096, 4), "float32")
    assert by == "operations" and 0.365 < ms < 0.372


# (n_o, n_v, naux, ngrid, nb): TTM flip-down, TTM flip-up, the bench width's flip-down
FLIP_SHAPES = {"ttm_down": (137, 46, 4412, 187644, 11), "ttm_up": (136, 45, 4412, 187644, 10),
               "bench_down": (80, 922, 2000, 49152, 10)}


@pytest.mark.parametrize("shape", list(FLIP_SHAPES.values()), ids=list(FLIP_SHAPES))
@pytest.mark.parametrize("kdim", [0, 1, 4])
def test_flip_kernel_counts_add_up_to_the_flip_sigma_count(shape, kdim):
    """Exchange-only K1 is the whole two-electron part of a flip build; the
    value-only K2 and K3 are its ALDA0 grid part up to terms linear in
    n_o; with four components their GGA minimum is half of what the
    per-einsum count of the multicollinear kernel gives."""
    n_o, n_v, naux, ngrid, nb = shape
    k1 = flops.df_exchange_flops(naux, nb, n_o, n_v, with_t=False)
    assert k1 == flops.sf_matvec_flops(n_o, n_v, naux, ngrid, nb, kdim=0)
    grid = flops.sf_matvec_flops(n_o, n_v, naux, ngrid, nb, kdim=kdim) - k1
    if kdim == 1:
        k23 = (flops.grid_rho1_flops(nb, n_o, n_v, ngrid, ncomp=1)
               + flops.grid_back_flops(nb, n_o, n_v, ngrid, ncomp=1))
        assert k23 - 3.0 * nb * ngrid * n_o == pytest.approx(grid, rel=1e-12)
    elif kdim == 4:
        k23 = (flops.grid_rho1_flops(nb, n_o, n_v, ngrid) + flops.grid_back_flops(nb, n_o, n_v, ngrid))
        assert k23 - 2.0 * nb * ngrid * 7 * (n_o + n_v) == pytest.approx(0.5 * grid, rel=1e-12)
    else:
        assert grid == 0.0
    assert flops.df_exchange_bytes(naux, nb, n_o, n_v, 8, with_t=False) < flops.df_exchange_bytes(
        naux, nb, n_o, n_v, 8)


@pytest.mark.parametrize("exchange", [True, False], ids=["hybrid", "pure"])
def test_scf_fock_build_counts(exchange):
    """One TTM SCF Fock build: K1 in AO mode is the flop count of K1 with
    nocc = nvir = nao on two density matrices, the grid stages are one
    AO-table GEMM each (2*nz*npts*nao^2 and the four AO rows), and the
    stages add up; without exchange, t and J are two matrix-vector products."""
    naux, nao, npts = 4412, 182, 187644
    f = flops.scf_veff_flops(naux, nao, npts, exchange=exchange)
    assert f["k1"] == (flops.df_exchange_flops(naux, 2, nao, nao) if exchange else 0.0)
    assert f["coulomb"] == 2.0 * naux * nao * nao * (1 if exchange else 2)
    assert f["k2"] == f["k3"] == flops.grid_ao_flops(2, nao, npts) == 4.0 * npts * (nao + 4) * nao
    assert f["total"] == f["k1"] + f["coulomb"] + f["k2"] + f["k3"]
    ms, by = flops.bound_ms(f["k2"], flops.grid_ao_bytes(2, nao, npts, 8), "float64")
    assert by == "operations" and 0.37 < ms < 0.39


def test_incore_sigma_grid_counts():
    """The in-core sigma's two AO modes at CH2O+/cc-pVDZ's stack (10
    matrices, 38 AO, 100,738 points): K3's value term at its least is one
    triangle of the outer product per point, (nao + 2) / (2 nao + 1) of
    K3's value-only count on two distinct tables, and its bytes read one AO row
    and one grid row; K2's mask adds one read per point."""
    nz, nao, npts = 10, 38, 100738
    assert flops.grid_ao_value_flops(nz, nao, npts) == nz * npts * (nao * nao + 2 * nao)
    assert flops.grid_ao_value_flops(nz, nao, npts) * (2 * nao + 1) == (
        flops.grid_back_flops(nz, nao, nao, npts, 1) * (nao + 2))
    assert flops.grid_ao_bytes(nz, nao, npts, 8, 1) == 8.0 * (npts * nao + nz * npts
                                                             + nz * nao * nao)
    assert flops.grid_ao_bytes(nz, nao, npts, 8, masked=True) == (
        flops.grid_ao_bytes(nz, nao, npts, 8) + 8.0 * npts)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_tau_and_rsh_counts(shape):
    """The meta-GGA and RSH terms of the sigma counts: the tau row of K2 adds
    three GEMMs (6*nz*nocc*nvir flops per point: the GGA minimum's 4
    become 10) and their dots with the gradient rows; K3's least with the
    tau term is its four-component sum, twice the GGA minimum's leading
    term, so its bound doubles; the sigma count's fifth component; an RSH
    adds one exchange-only K1 pass per spin block."""
    nc, no, nv, naux, ngrid, nb = shape
    blocks = ((nc + no, nv), (nc, no + nv))
    for o, v in blocks:
        assert (flops.grid_rho1_flops(nb, o, v, ngrid, 5) - flops.grid_rho1_flops(nb, o, v, ngrid)
                == 2.0 * nb * ngrid * (3 * o * v + 3 * o))
        assert flops.grid_rho1_flops(nb, o, v, ngrid, 5) == pytest.approx(
            2.0 * nb * ngrid * (5 * o * v + 7 * o + 3 * v))
        lead = flops.grid_back_flops(nb, o, v, ngrid, 5) - 20.0 * nb * ngrid * o
        assert lead == 2.0 * (flops.grid_back_flops(nb, o, v, ngrid)
                              - 2.0 * nb * ngrid * (3 * o + 4 * v))
        # tau reads no fifth table row, and writes one more grid row
        assert (flops.grid_rho1_bytes(nb, o, v, ngrid, 8, 5) - flops.grid_rho1_bytes(nb, o, v, ngrid, 8)
                == 8.0 * nb * ngrid)
        assert (flops.grid_back_bytes(nb, o, v, ngrid, 8, 5) - flops.grid_back_bytes(nb, o, v, ngrid, 8)
                == 8.0 * nb * ngrid)
    assert flops.matvec_flops(*shape, tau=True) - flops.matvec_flops(*shape) == sum(
        4.0 * ngrid * o * v * nb for o, v in blocks)
    assert flops.matvec_flops(*shape, hyb_terms=2) - flops.matvec_flops(*shape) == pytest.approx(
        sum(flops.df_exchange_flops(naux, nb, o, v, with_t=False) for o, v in blocks), rel=1e-12)
    n_o, n_v = nc + no, no + nv
    assert (flops.sf_matvec_flops(n_o, n_v, naux, ngrid, nb, kdim=5, hyb_terms=2)
            - flops.sf_matvec_flops(n_o, n_v, naux, ngrid, nb, kdim=4)
            == flops.df_exchange_flops(naux, nb, n_o, n_v, with_t=False)
            + 4.0 * ngrid * n_o * n_v * nb)


def test_tau_bounds_at_the_ttm_shapes():
    """K3's bound doubles with the tau term on one TTM chunk (10 vectors,
    f64); on the AO table, K2 and K3 with tau each do 2*(4*nao^2 + 7*nao)
    per matrix and point, and the RSH SCF adds an exchange-only K1 pass."""
    ms4, _ = flops.bound_ms(flops.grid_back_flops(10, 137, 45, 4096),
                            flops.grid_back_bytes(10, 137, 45, 4096, 8), "float64")
    ms5, by = flops.bound_ms(flops.grid_back_flops(10, 137, 45, 4096, 5),
                             flops.grid_back_bytes(10, 137, 45, 4096, 8, 5), "float64")
    assert by == "operations" and 1.9 < ms5 / ms4 < 2.1
    naux, nao, npts = 4412, 182, 187644
    f = flops.scf_veff_flops(naux, nao, npts, tau=True, lr=True)
    assert f["k2"] == f["k3"] == flops.grid_ao_flops(2, nao, npts, tau=True) == (
        4.0 * npts * (4 * nao * nao + 7 * nao))
    assert f["k1_lr"] == flops.df_exchange_flops(naux, 2, nao, nao, with_t=False)
    assert f["total"] == f["k1"] + f["coulomb"] + f["k1_lr"] + f["k2"] + f["k3"]
    assert flops.grid_ao_bytes(2, nao, npts, 8, 5) - flops.grid_ao_bytes(2, nao, npts, 8) == (
        8.0 * 2 * npts)

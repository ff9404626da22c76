"""The frozen work counts against counts made by hand at small shapes."""

import math

import pytest

from xbench import counts


def test_df_exchange_by_hand():
    # naux 2, one vector, nocc 1, nvir 3: t 2*2*1*3 = 12, T 2*2*1*3*3 = 36,
    # K 2*2*1*1*3 = 12 multiply-adds doubled
    assert counts.df_exchange_flops(2, 1, 1, 3) == 12 + 36 + 12
    assert counts.df_exchange_flops(2, 1, 1, 3, with_t=False) == 36 + 12
    # reads: oo 2*1, vv 2*9, z 3, ov 2*3; writes: K 3, t 2 (8-byte items)
    assert counts.df_exchange_bytes(2, 1, 1, 3, 8) == 8 * (2 + 18 + 3 + 6 + 3 + 2)
    assert counts.df_exchange_bytes(2, 1, 1, 3, 8, with_t=False) == 8 * (2 + 18 + 3 + 3)


def test_grid_contractions_by_hand():
    nz, o, v, g = 2, 3, 5, 7
    # K2 GGA: tmp and u (2ov each), rho1 (2o), three gradient rows (6o + 6v)
    assert counts.grid_rho1_flops(nz, o, v, g) == nz * g * (4 * o * v + 2 * o + 6 * o + 6 * v)
    # K3 GGA: F0 and G (8 + 6 flops per o and v), the two GEMM rows (4ov)
    assert counts.grid_back_flops(nz, o, v, g) == nz * g * (4 * o * v + 6 * o + 8 * v)
    # value alone: K2 tmp + dot (2ov + 2o), K3 weight and outer product (2ov + o)
    assert counts.grid_rho1_flops(nz, o, v, g, 1) == nz * g * (2 * o * v + 2 * o)
    assert counts.grid_back_flops(nz, o, v, g, 1) == nz * g * (2 * o * v + o)
    assert counts.grid_rho1_bytes(nz, o, v, g, 4, ncomp=1, masked=False) == \
        4 * (g * (o + v) + nz * o * v + nz * g)


@pytest.mark.parametrize("method", ["xtda", "xsf"])
def test_build_work_sums_its_blocks(method):
    s = counts.Shapes(method, nc=3, no=2, nv=5, naux=4, ngrid=6, dtype="float64")
    w = counts.build_work(s, 2)
    if method == "xtda":
        blocks = ((5, 5), (3, 7))
        assert w["k1"][0] == sum(counts.df_exchange_flops(4, 2, o, v) for o, v in blocks)
        assert w["coulomb"][0] == sum(2 * 4 * o * v * 2 for o, v in blocks)
    else:
        assert w["k1"][0] == counts.df_exchange_flops(4, 2, 5, 7, with_t=False)
        assert w["coulomb"] == (0.0, 0.0)
    least = counts.build_least_s(s, 2)
    assert math.isclose(least, max(sum(f for f, _ in w.values()) / 67e12,
                                   sum(b for _, b in w.values()) / 3.35e12))


def test_ttmdzp_build_at_the_published_widths():
    """A 21-vector X-TDA build at TTM's DZ+P widths: K1's flops by hand
    (t, T = B_vv z, K = T B_ov for each spin's block), at the f32 peak."""
    s = counts.Shapes("xtda", nc=136, no=1, nv=461, naux=3990, ngrid=187644, dtype="float32")
    # alpha (137 occupied x 461 virtual) and beta (136 x 462) blocks
    flops = sum(2 * 3990 * 21 * o * v + 2 * 3990 * 21 * o * v * v + 2 * 3990 * 21 * o * o * v
                for o, v in ((137, 461), (136, 462)))
    assert math.isclose(counts.build_work(s, 21)["k1"][0], flops)
    assert math.isclose(counts.build_least_s(s, 21, ("k1",)), flops / 67e12)

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


def test_grid_back_span_equals_its_chunks():
    """One K3 call on a span of grid chunks (as the sigma makes it, once per
    jvp group) equals the sum of its per-chunk calls (plain version, f64)."""
    rng = np.random.default_rng(3)
    nchunk, gc = 3, 64
    table = torch.as_tensor(rng.normal(size=(4, nchunk * gc + 32, NMO)))
    phi = table[:, 16:16 + nchunk * gc]  # a strided view, as in the sigma
    dwv = torch.as_tensor(rng.normal(size=(NZ, nchunk * gc)))
    dwg = torch.as_tensor(rng.normal(size=(NZ, 3, nchunk * gc)))
    span = k3.grid_back(dwv, dwg, phi, 0, NOCC, torch.zeros((NZ, NOCC, NMO - NOCC),
                                                            dtype=torch.float64))
    per = torch.zeros_like(span)
    for c in range(nchunk):
        k = slice(c * gc, (c + 1) * gc)
        k3.grid_back(dwv[:, k], dwg[..., k], phi[:, k], 0, NOCC, per)
    _rel_close(span, per.numpy(), RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_grid_rho1_span_equals_its_chunks(masked):
    """One K2 call on a span of grid chunks (as the sigma makes it, once per
    jvp group) equals its per-chunk calls side by side (plain version, f64)."""
    rng = np.random.default_rng(9)
    nchunk, gc = 3, 64
    table = torch.as_tensor(rng.normal(size=(4, nchunk * gc + 32, NMO)))
    phi = table[:, 16:16 + nchunk * gc]  # a strided view, as in the sigma
    z = torch.as_tensor(rng.normal(size=(NZ, NOCC, NMO - NOCC)))
    mask = torch.as_tensor(rng.uniform(size=nchunk * gc) > 0.2, dtype=torch.float64)
    m = mask if masked else None
    span = k2.grid_rho1(phi, z, 0, NOCC, m)
    per = [k2.grid_rho1(phi[:, c * gc:(c + 1) * gc], z, 0, NOCC,
                        None if m is None else m[c * gc:(c + 1) * gc]) for c in range(nchunk)]
    _rel_close(span, torch.cat(per, dim=-1).numpy(), RTOL)


def _emulate_rho1(phi, z, o0, v0, phi_v, ncomp, dtype):
    """rho1 as the CUDA kernel forms it from the wrapper's operands
    (`csrc/grid_rho1.cu`): tmp = za^T pv_0 over k, its rows (x, i) against
    po_c[:, o0 - so + i], and u = zb^T po_0 against pv_c[:, v0 - sv + i], the
    value row on one of the two, in f64 whatever the layout's type."""
    nz, nocc, nvir = z.shape
    pv = phi if phi_v is None else phi_v
    zt = z.to(dtype)
    so, sv, za, ra, zb, rb, vu = k2.operands(zt, o0, v0, ncomp)
    assert vu == (nvir < nocc)
    out = torch.zeros((nz, ncomp, phi.shape[1]), dtype=torch.float64)

    def gemm(a, r, nrow, b_cols, table, e0, comps):
        a = a.double()
        assert a.shape[2] == r and r % k2._ROW_GROUP[zt.element_size()] == 0
        # rows i >= nrow are zero in a; the table is read only below nrow
        c = torch.einsum("kxi,gk->xig", a[:, :, :nrow], b_cols)
        for comp in comps:
            out[:, comp] += torch.einsum("xig,gi->xg", c, table[comp][:, e0:e0 + nrow])

    tmp_comps = [c for c in range(ncomp) if c > 0 or not vu]
    u_comps = [c for c in range(ncomp) if c > 0 or vu]
    assert (za is None) == (not tmp_comps) and (zb is None) == (not u_comps)
    if tmp_comps:
        gemm(za, ra, so + nocc, pv[0][:, v0 - sv:v0 + nvir], phi, o0 - so, tmp_comps)
    if u_comps:
        gemm(zb, rb, sv + nvir, phi[0][:, o0 - so:o0 + nocc], pv, v0 - sv, u_comps)
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ncomp", [1, 4])
@pytest.mark.parametrize("o0,nocc,v0,nvir,two", [(0, 11, 11, 23, False), (0, 23, 23, 11, False),
                                                 (3, 11, 9, 23, False), (1, 20, 14, 9, True)],
                         ids=["xtda", "more_occupied", "overlap", "offsets_two_tables"])
def test_grid_rho1_operands_give_plain(o0, nocc, v0, nvir, two, ncomp, dtype):
    """The A operands that the wrapper lays out (shifted, padded per trial
    vector, the value row on the GEMM of fewer rows), contracted as the
    kernel's two GEMMs and tile epilogues, give the plain version: the
    layout contract between wrapper and kernel."""
    rng = np.random.default_rng(10)
    z = torch.as_tensor(rng.normal(size=(NZ, nocc, nvir))).to(dtype).double()
    phi = torch.as_tensor(rng.normal(size=(4, GC, NMO)))
    phi_v = torch.as_tensor(rng.normal(size=(4, GC, NMO))) if two else None
    want = k2.grid_rho1_plain(phi, z, o0, v0, None, phi_v, ncomp)
    _rel_close(_emulate_rho1(phi, z, o0, v0, phi_v, ncomp, dtype), want.numpy(), RTOL)


# ---- the spin-flip modes: overlapping o/v ranges, a second tensor or table ----

N_O, V0 = 13, 9  # o = [0, 13), v = [9, 40): they share four orbitals
N_V = NMO - V0


def _flip_inputs(seed, two):
    rng = np.random.default_rng(seed)
    sym = lambda a: 0.5 * (a + a.transpose(0, 2, 1))
    B = sym(rng.normal(size=(NAUX, NMO, NMO)))
    Bv = sym(rng.normal(size=(NAUX, NMO, NMO))) if two else None
    phi = rng.normal(size=(4, GC, NMO))
    phi_v = rng.normal(size=(4, GC, NMO)) if two else None
    z = rng.normal(size=(NZ, N_O, N_V))
    return B, Bv, phi, phi_v, z, rng


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("two", [False, True], ids=["one_tensor", "two_tensors"])
@pytest.mark.parametrize("chunk", [None, 16])
def test_df_exchange_flip_plain_matches_dense(two, chunk):
    """Exchange-only K1 against the dense (ij|ab) contraction as the JAX flip
    sigmas write it (`sigma_df.py:829-830`: B_occ[P,i,j], B_vir[P,a,b])."""
    B, Bv, *_, z, _ = _flip_inputs(4, two)
    Bo = jnp.asarray(B)[:, :N_O, :N_O]
    Bvv = jnp.asarray(B if Bv is None else Bv)[:, V0:, V0:]
    want = jnp.einsum("Pij,Pab,xjb->xia", Bo, Bvv, jnp.asarray(z))
    t, K = k1.df_exchange(_t(B), _t(z), 0, V0, chunk, B_vir=_t(Bv), with_t=False)
    assert t is None
    _rel_close(K, want, RTOL)


def test_df_exchange_second_tensor_has_no_coulomb_term():
    B, Bv, *_, z, _ = _flip_inputs(4, True)
    with pytest.raises(ValueError, match="with_t=False"):
        k1.df_exchange(_t(B), _t(z), 0, V0, B_vir=_t(Bv))


@pytest.mark.parametrize("two", [False, True], ids=["one_table", "two_tables"])
@pytest.mark.parametrize("ncomp", [1, 4])
def test_grid_rho1_flip_plain_matches_dense(two, ncomp):
    """rho1_c[x,g] = sum_ov z[x,o,v] d_c(po[g,o] pv[g,v]) written out densely."""
    _, _, phi, phi_v, z, rng = _flip_inputs(5, two)
    po = jnp.asarray(phi)[:, :, :N_O]
    pv = jnp.asarray(phi if phi_v is None else phi_v)[:, :, V0:]
    zj = jnp.asarray(z)
    rows = [jnp.einsum("xov,go,gv->xg", zj, po[0], pv[0])]
    for y in (1, 2, 3)[:ncomp - 1]:
        rows.append(jnp.einsum("xov,go,gv->xg", zj, po[y], pv[0])
                    + jnp.einsum("xov,go,gv->xg", zj, po[0], pv[y]))
    want = np.stack([np.asarray(r) for r in rows], axis=1)
    out = k2.grid_rho1(_t(phi), _t(z), 0, V0, None, phi_v=_t(phi_v), ncomp=ncomp)
    _rel_close(out, want, RTOL)
    mask = rng.uniform(size=GC) > 0.2
    out = k2.grid_rho1(_t(phi), _t(z), 0, V0, torch.as_tensor(mask, dtype=torch.float64),
                       phi_v=_t(phi_v), ncomp=ncomp)
    _rel_close(out, want * mask, RTOL)


@pytest.mark.parametrize("two", [False, True], ids=["one_table", "two_tables"])
@pytest.mark.parametrize("ncomp", [1, 4])
def test_grid_back_flip_plain_matches_dense(two, ncomp):
    """v[x,o,v] = sum_g sum_c wv[x,c,g] d_c(po[g,o] pv[g,v]) written out densely."""
    _, _, phi, phi_v, _, rng = _flip_inputs(6, two)
    po = jnp.asarray(phi)[:, :, :N_O]
    pv = jnp.asarray(phi if phi_v is None else phi_v)[:, :, V0:]
    wv = rng.normal(size=(NZ, ncomp, GC))
    want = jnp.einsum("xg,go,gv->xov", wv[:, 0], po[0], pv[0])
    for y in (1, 2, 3)[:ncomp - 1]:
        want = want + jnp.einsum("xg,go,gv->xov", wv[:, y], po[y], pv[0])
        want = want + jnp.einsum("xg,go,gv->xov", wv[:, y], po[0], pv[y])
    acc = torch.full((NZ, N_O, N_V), 0.25, dtype=torch.float64)
    dwg = _t(np.ascontiguousarray(wv[:, 1:4])) if ncomp == 4 else None
    out = k3.grid_back(_t(np.ascontiguousarray(wv[:, 0])), dwg, _t(phi), 0, V0, acc,
                       phi_v=_t(phi_v))
    assert out is acc
    _rel_close(out - 0.25, want, RTOL)


@pytest.mark.parametrize("case", ["k1", "k2-value", "k2-four", "k3-value", "k3-four"])
def test_flip_plain_f32_close_to_f64(case):
    """The plain versions are what the kernels are held against in f32 on the
    card: in f32 they agree with their f64 selves to the f32 tolerance there."""
    B, Bv, phi, phi_v, z, rng = _flip_inputs(8, True)
    wv = rng.normal(size=(NZ, 4, GC))

    def run(dt):
        c = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dt)
        if case == "k1":
            return k1.df_exchange_plain(c(B), c(z), 0, V0, None, c(Bv), False)[1]
        ncomp = 1 if case.endswith("value") else 4
        if case.startswith("k2"):
            return k2.grid_rho1_plain(c(phi), c(z), 0, V0, None, c(phi_v), ncomp)
        out = torch.zeros((NZ, N_O, N_V), dtype=dt)
        dwg = c(wv[:, 1:4]) if ncomp == 4 else None
        return k3.grid_back_plain(c(wv[:, 0]), dwg, c(phi), 0, V0, out, c(phi_v))

    got, want = run(torch.float32), run(torch.float64)
    assert got.dtype == torch.float32
    _rel_close(got.double(), want.numpy(), 1e-4)


def test_grid_rho1_refuses_other_component_counts():
    _, _, phi, _, z, _ = _flip_inputs(5, False)
    with pytest.raises(ValueError, match="ncomp"):
        k2.grid_rho1(_t(phi), _t(z), 0, V0, None, ncomp=3)


@pytest.mark.parametrize("shape", [(10, 137, 46), (11, 136, 45), (21, 80, 922), (10, 80, 922)],
                         ids=["ttm_down", "ttm_up", "bench_nz21", "bench_nz10"])
def test_df_exchange_flip_chunk_fits_budget(shape):
    """n_o > n_v at TTM: the planned T chunk stays within the 1 GiB budget."""
    nz, n_o, n_v = shape
    naux, isz = (4412, 8) if n_o > 100 else (2000, 4)
    chunk = k1.plan_aux_chunk(naux, nz, n_o, n_v, isz)
    assert 1 <= chunk <= naux
    assert chunk * n_o * (-(-nz * n_v // (16 // isz)) * (16 // isz)) * isz <= k1.T_BUDGET_BYTES


@pytest.mark.parametrize("naux", [1, 7, 257, 4412])
@pytest.mark.parametrize("budget", [1, 10_000, 1 << 20, 1 << 30])
def test_df_exchange_aux_plan_covers_naux(naux, budget):
    """The K1 wrapper's T budget gives aux chunks that cover naux exactly,
    each within the budget (a single aux index when even one is over)."""
    nz, nocc, nvir, itemsize = 3, 11, 29, 8
    per_aux = nocc * 88 * itemsize  # a T row of nz*nvir = 87 elements, padded to 16 bytes
    chunk = k1.plan_aux_chunk(naux, nz, nocc, nvir, itemsize, budget)
    # the [P0, P1) ranges the kernel walks
    ranges = [(p0, min(naux, p0 + chunk)) for p0 in range(0, naux, chunk)]
    assert ranges[0][0] == 0 and ranges[-1][1] == naux
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(p1 - p0 == chunk for p0, p1 in ranges[:-1]) and ranges[-1][1] > ranges[-1][0]
    assert chunk == 1 or chunk * per_aux <= budget
    # as few chunks as the budget allows
    assert len(ranges) == -(-naux // max(1, min(naux, budget // per_aux)))


@pytest.mark.parametrize("empty", ["nz", "nocc", "nvir", "naux"])
def test_df_exchange_refuses_an_empty_extent(empty):
    """The K1 wrapper raises ValueError on an empty extent before it plans
    its aux chunk, for CPU tensors too."""
    n = {"nz": 2, "nocc": 3, "nvir": 4, "naux": 5, empty: 0}
    B = torch.zeros((n["naux"], 8, 8), dtype=torch.float64)
    z = torch.zeros((n["nz"], n["nocc"], n["nvir"]), dtype=torch.float64)
    with pytest.raises(ValueError, match="empty extent"):
        k1.df_exchange(B, z, 0, 3, with_t=False)


# ---- the SCF's AO modes: the AO basis on both sides, density matrices as z ----

def _ao_inputs(seed):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(NAUX, NMO, NMO))
    B = 0.5 * (B + B.transpose(0, 2, 1))
    c = rng.normal(size=(2, NMO, 7))
    dms = np.einsum("xmi,xni->xmn", c, c)  # symmetric, one per spin
    ao = rng.normal(size=(4, GC, NMO))
    return B, dms, ao, rng


@pytest.mark.parametrize("chunk", [None, 16])
def test_df_exchange_ao_mode_matches_jax_scf(chunk):
    """K1 with o0 = v0 = 0 and nocc = nvir = nao on a stack of density
    matrices: its t gives `scf/env.py:238` `_df_j`, its K `:244` `_df_k`."""
    from xtddft_tpu.scf.env import _df_j, _df_k

    B, dms, _, _ = _ao_inputs(20)
    t, K = k1.df_exchange(torch.as_tensor(B), torch.as_tensor(dms), 0, 0, chunk)
    Bt = torch.as_tensor(B)
    J = (t.sum(0) @ Bt.reshape(NAUX, -1)).reshape(NMO, NMO)
    _rel_close(J, _df_j(jnp.asarray(B), jnp.asarray(dms.sum(0))), RTOL)
    for x in range(2):
        _rel_close(K[x], _df_k(jnp.asarray(B), jnp.asarray(dms[x])), RTOL)


def test_grid_rho1_hermi_matches_jax_cache_rho():
    """K2's hermitian mode on the AO table: `xc/interface.py:53` `cache_rho`
    of each density matrix, value and gradient."""
    from xtddft_tpu.xc.interface import cache_rho

    _, dms, ao, _ = _ao_inputs(21)
    out = k2.grid_rho1(torch.as_tensor(ao), torch.as_tensor(dms), 0, 0, hermi=True)
    for x in range(2):
        rho, grho = cache_rho(jnp.asarray(ao), jnp.asarray(dms[x]))
        _rel_close(out[x, 0], rho, RTOL)
        _rel_close(out[x, 1:4], grho, RTOL)


def test_grid_back_ao_mode_matches_jax_contract_vmat():
    """K3 with the AO table on both sides: `xc/interface.py:112`
    `_contract_vmat` (A + B + B^T) of each spin's weighted derivatives."""
    from xtddft_tpu.xc.interface import _contract_vmat

    _, _, ao, rng = _ao_inputs(22)
    wv, wg = rng.normal(size=(2, GC)), rng.normal(size=(2, 3, GC))
    out = k3.grid_back(torch.as_tensor(wv), torch.as_tensor(wg), torch.as_tensor(ao), 0, 0,
                       torch.zeros((2, NMO, NMO), dtype=torch.float64))
    for x in range(2):
        _rel_close(out[x], _contract_vmat(jnp.asarray(ao), jnp.asarray(wv[x]),
                                          jnp.asarray(wg[x])), RTOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("o0", [0, 3])
def test_grid_rho1_hermi_operand_gives_plain(o0, dtype):
    """The hermitian mode's one A operand (tmp's), contracted as the kernel
    does (every row from tmp, the gradient rows doubled), gives the plain
    version: the layout contract of that mode."""
    rng = np.random.default_rng(23)
    n = 17
    c = rng.normal(size=(NZ, n, 5))
    z = torch.as_tensor(np.einsum("xmi,xni->xmn", c, c)).to(dtype).double()
    phi = torch.as_tensor(rng.normal(size=(4, GC, NMO)))
    so, sv, za, ra, zb, rb, vu = k2.operands(z.to(dtype), o0, o0, 4, hermi=True)
    assert zb is None and rb == 0 and not vu and ra % k2._ROW_GROUP[za.element_size()] == 0
    tmp = torch.einsum("kxi,gk->xig", za.double()[:, :, :so + n],
                       phi[0][:, o0 - sv:o0 + n])
    out = torch.stack([torch.einsum("xig,gi->xg", tmp, phi[c][:, o0 - so:o0 + n])
                       * (2.0 if c else 1.0) for c in range(4)], dim=1)
    want = k2.grid_rho1_plain(phi, z, o0, o0, None, None, 4, hermi=True)
    _rel_close(out, want.numpy(), RTOL)


def test_grid_rho1_hermi_refuses_two_sides():
    """The hermitian mode is explicit and needs one table and a square z."""
    z = torch.zeros((1, 4, 4), dtype=torch.float64)
    phi = torch.zeros((4, 8, 6), dtype=torch.float64)
    for kw in ({"phi_v": phi}, {"o0": 0, "v0": 1}):
        args = {"o0": 0, "v0": 0, **kw}
        with pytest.raises(ValueError):
            k2.grid_rho1(phi, z, args.pop("o0"), args.pop("v0"), hermi=True, **args)
    with pytest.raises(ValueError):
        k2.grid_rho1(phi, torch.zeros((1, 4, 3), dtype=torch.float64), 0, 0, hermi=True)

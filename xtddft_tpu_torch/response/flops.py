"""Operation and byte counts of the sigma build and of its kernels.

``matvec_flops`` counts one blocked DF X-TDA sigma build the way the
repository's benchmark does (the port keeps its own copy);
``sf_matvec_flops`` one spin-flip build the same way.  The per-kernel
counts give each kernel's bound on the card: the larger of its operations
over the peak rate for its type and its bytes over the memory rate, with
every input read once and every output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM at its 700 W limit (data sheet, dense, no sparsity)
PEAK_FLOPS = {"float64": 67e12,  # f64 on the tensor cores (DMMA)
              "float32": 67e12}  # f32 FMA (TF32 stays off)
HBM_BYTES_PER_S = 3.35e12


def matvec_flops(nc, no, nv, naux, ngrid, nb, hyb_terms=1, tau=False, with_b=False):
    """Analytic flop count of one blocked DF X-TDA sigma build (nb vectors).

    Counted per einsum of the DF sigma (2 flops per multiply-add).  The
    dominant term is the exchange half-transform
    T[x,P,j,a] = B[P,ab] z[x,jb]: 2*naux*nocc*nvir^2*nb per spin block.
    hyb_terms: 1, +1 more if an RSH long-range B adds a second K pass (2:
    CAM-B3LYP).  tau: a meta-GGA's fifth grid component (the tau row and
    term), counted like the other four.  with_b: the paired (A z, B z)
    build of TDHF/RPA, whose B half adds one RPA exchange per spin and
    K pass (``rpa_exchange_flops``); its Coulomb and fxc terms are A's.
    """
    na_o, na_v = nc + no, nv          # alpha occ/vir
    nb_o, nb_v = nc, no + nv          # beta occ/vir
    jk = 0.0
    for o, v in ((na_o, na_v), (nb_o, nb_v)):
        t = 2.0 * naux * o * v * nb            # t_P = B_ov . z
        T = 2.0 * naux * o * v * v * nb        # T = B_vv . z
        K = 2.0 * naux * o * o * v * nb        # K = B_oo . T
        back = 2.0 * naux * o * v * nb         # v1 += B_ov . t
        jk += t + back + hyb_terms * (T + K)
        if with_b:
            jk += hyb_terms * rpa_exchange_flops(naux, nb, o, v)
    fxc = 0.0
    ncomp = 5 if tau else 4
    for o, v in ((na_o, na_v), (nb_o, nb_v)):
        # rho1 forward (4 gradient components, 5 with tau) + backward, each
        # ~2*ngrid*o*v*nb per component
        fxc += 2.0 * 2.0 * ncomp * ngrid * o * v * nb
    return jk + fxc


def sf_matvec_flops(n_o, n_v, naux, ngrid, nb, kdim=1, hyb_terms=1):
    """Analytic flop count of one blocked DF spin-flip sigma build (nb
    vectors) on its (n_o, n_v) block, counted per einsum like
    ``matvec_flops``: the exchange half-transform and back-contraction (no
    Coulomb term in a flip channel), and the SF kernel's transition density
    and back-projection at 2*ngrid*n_o*n_v*nb each per component (kdim 1:
    ALDA0; 4: multicollinear; 5: multicollinear with a meta-GGA's tau; 0:
    collinear, no grid term).  hyb_terms: 2 with an RSH's long-range K."""
    T = 2.0 * naux * n_o * n_v * n_v * nb
    K = 2.0 * naux * n_o * n_o * n_v * nb
    return hyb_terms * (T + K) + 2.0 * 2.0 * kdim * ngrid * n_o * n_v * nb


def df_exchange_flops(naux, nz, nocc, nvir, with_t=True):
    """K1: t (2*naux*nz*nocc*nvir, unless exchange-only), T (... * nvir) and
    K (... * nocc)."""
    return 2.0 * naux * nz * nocc * nvir * (nvir + nocc + (1 if with_t else 0))


def df_exchange_bytes(naux, nz, nocc, nvir, itemsize, with_t=True):
    """K1: the oo, vv and (for t) ov blocks of B and z read; t and K written."""
    reads = naux * (nocc * nocc + nvir * nvir) + nz * nocc * nvir
    writes = nz * nocc * nvir
    if with_t:
        reads += naux * nocc * nvir
        writes += nz * naux
    return float(itemsize) * (reads + writes)


def rpa_exchange_flops(naux, nz, nocc, nvir):
    """K1's RPA exchange in the cheaper order: two GEMMs of
    2*naux*nz*nocc*nvir*min(nocc, nvir) each."""
    return 4.0 * naux * nz * nocc * nvir * min(nocc, nvir)


def rpa_exchange_bytes(naux, nz, nocc, nvir, itemsize):
    """K1's RPA exchange: the ov block of B and z read, v written."""
    return float(itemsize) * (naux * nocc * nvir + 2 * nz * nocc * nvir)


def stda_j_flops(nrow, ncol, natm):
    """K4: a multiply and an add per atom for each element of J."""
    return 2.0 * nrow * ncol * natm


def stda_j_bytes(nrow, ncol, natm, nocc, nvir, itemsize, diagonal=False):
    """K4: the two tables (natm x nocc^2 and natm x nvir^2) and the four
    int32 index lists read once, J written (nrow elements on the diagonal)."""
    tables = natm * (nocc * nocc + nvir * nvir) * itemsize
    if diagonal:
        return float(tables + 2 * 4 * nrow + itemsize * nrow)
    return float(tables + 2 * 4 * (nrow + ncol) + itemsize * nrow * ncol)


def grid_back_flops(nz, nocc, nvir, npts, ncomp=4):
    """K3, the least a GGA back-projection needs: per vector and point,
    r += [phi0_o, E] [G; phi0_v] with E = sum_y dwg_y phiy_o and
    G = dwv phi0_v + sum_y dwg_y phiy_v, i.e. 4*nocc*nvir + 6*nocc + 8*nvir.
    (The kernel contracts over 4 components, twice the leading term.)
    With the meta-GGA tau term (ncomp 5) the least is the four-component
    sum the kernel does, r += sum_c F_c phic_v with F_0 = dwv phi0_o +
    sum_y dwg_y phiy_o and F_y = dwg_y phi0_o + dwt/2 phiy_o, i.e.
    8*nocc*nvir + 20*nocc: the kernel's count, so its bound doubles.
    Value-only (ncomp 1): r += (dwv phi0_o) phi0_v, 2*nocc*nvir + nocc,
    which the kernel does."""
    if ncomp == 1:
        return 1.0 * nz * npts * (2 * nocc * nvir + nocc)
    if ncomp == 5:
        return 2.0 * nz * npts * (4 * nocc * nvir + 10 * nocc)
    return 2.0 * nz * npts * (2 * nocc * nvir + 3 * nocc + 4 * nvir)


def grid_back_bytes(nz, nocc, nvir, npts, itemsize, ncomp=4):
    """K3: phi_c[g, o] and phi_c[g, v] (four rows at most), dwv, dwg and
    dwt (ncomp 5) read; out read and written once (it accumulates)."""
    reads = min(ncomp, 4) * npts * (nocc + nvir) + ncomp * nz * npts + nz * nocc * nvir
    return float(itemsize) * (reads + nz * nocc * nvir)


def grid_rho1_flops(nz, nocc, nvir, npts, ncomp=4):
    """K2, the least a GGA transition density needs: per vector and point,
    tmp = z . phi0_v and u = z^T . phi0_o (4*nocc*nvir), rho1 = phi0_o . tmp
    (2*nocc) and grad_y rho1 = phiy_o . tmp + phiy_v . u (6*(nocc + nvir)).
    (The kernel contracts z with all four phi_c[g, v], twice the leading
    term.)  The meta-GGA tau row (ncomp 5) adds tmp_y = z . phiy_v and its
    dots with phiy_o, 6*nocc*nvir + 6*nocc, which the kernel does: the
    4*nz*nocc*nvir flops per point become 10.  Value-only (ncomp 1): tmp
    and rho1 alone, 2*nocc*nvir + 2*nocc, which the kernel does."""
    if ncomp == 1:
        return 2.0 * nz * npts * (nocc * nvir + nocc)
    if ncomp == 5:
        return 2.0 * nz * npts * (5 * nocc * nvir + 7 * nocc + 3 * nvir)
    return 2.0 * nz * npts * (2 * nocc * nvir + 4 * nocc + 3 * nvir)


def grid_rho1_bytes(nz, nocc, nvir, npts, itemsize, ncomp=4, masked=True):
    """K2: phi_c[g, o], phi_c[g, v] (four rows at most), z and the mask read;
    (nz, ncomp, g) written."""
    reads = min(ncomp, 4) * npts * (nocc + nvir) + nz * nocc * nvir + (npts if masked else 0)
    return float(itemsize) * (reads + ncomp * nz * npts)


def grid_ao_flops(nz, nao, npts, tau=False):
    """The SCF's grid work per stage, K2 hermitian (the density on the grid:
    tmp = dm . phi0, 2*nao^2 per matrix and point, and its dots with the
    four AO rows, 8*nao), which the kernel does, and K3 on the AO table
    (the XC potential matrix) at its least: V' = sum_g phi0_m F_n with
    F = wv/2 phi0 + sum_y wvec_y phiy (8*nao per point), then V' + V'^T,
    the same count; K3 contracts over four components, four times its
    leading term.  With a meta-GGA's tau (``tau``): K2 adds dm . phiy and
    their dots with phiy (6*nao^2 + 6*nao), which it does, and K3's least
    becomes four outer products, V'' = sum_g (phi0 F^T + sum_y phiy
    (wtau/4 phiy)^T), then V'' + V''^T, which it does: both
    2*(4*nao^2 + 7*nao)."""
    if tau:
        return 2.0 * nz * npts * (4 * nao * nao + 7 * nao)
    return 2.0 * nz * npts * (nao * nao + 4 * nao)


def grid_ao_value_flops(nz, nao, npts):
    """K3's value term on the AO table at its least: V = sum_g (dwv phi0)
    phi0^T is symmetric, so per point F = dwv phi0 (nao) and one triangle
    of F phi0^T, nao (nao + 1) / 2 multiply-adds."""
    return 1.0 * nz * npts * (nao * (nao + 1) + nao)


def grid_ao_bytes(nz, nao, npts, itemsize, ncomp=4, masked=False):
    """K2 hermitian / K3 AO mode: the ncomp rows of the AO table read once
    (four at most: the tau row, ncomp 5, reads the gradient rows), the (nz,
    ncomp, npts) grid side and the (nz, nao, nao) matrices read or written
    once, and K2's mask read once where it has one."""
    return float(itemsize) * (min(ncomp, 4) * npts * nao + ncomp * nz * npts + nz * nao * nao
                              + (npts if masked else 0))


def scf_veff_flops(naux, nao, npts, nz=2, exchange=True, xc=True, tau=False, lr=False):
    """One SCF Fock build on the port's path, per stage: K1 in AO mode (t
    and K of nz density matrices), the Coulomb GEMM J = B . t, K2
    hermitian, K3 in AO mode (the functional's own work is not counted);
    without exchange, t = B . dm is a second matrix-vector product.
    ``tau``: a meta-GGA's K2 tau row and K3 tau term; ``lr``: an RSH's
    second, exchange-only K1 pass on the erf-attenuated fit.
    Returns {stage: flops} with the total under "total"."""
    out = {"k1": df_exchange_flops(naux, nz, nao, nao) if exchange else 0.0,
           # J = B . t, and t = B . dm without K1 (no exchange)
           "coulomb": 2.0 * naux * nao * nao * (1 if exchange else 2),
           "k1_lr": df_exchange_flops(naux, nz, nao, nao, with_t=False) if lr else 0.0,
           "k2": grid_ao_flops(nz, nao, npts, tau) if xc else 0.0,
           "k3": grid_ao_flops(nz, nao, npts, tau) if xc else 0.0}
    out["total"] = sum(out.values())
    return out


def bound_ms(flops, nbytes, dtype_name):
    """(least time in ms, "operations" or "bytes") on the card."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_mem = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes")

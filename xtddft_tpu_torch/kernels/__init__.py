"""Hand-written CUDA kernels of the main path, each beside its plain version.

| kernel        | replaces (JAX package)                 | module        | design                                        |
|---------------|----------------------------------------|---------------|-----------------------------------------------|
| `df_exchange` | `response/sigma_df.py:399` `_jk`, `:821`/`:1066` the flip `_k` | `df_exchange` | two GEMMs on the tile core (`csrc/gemm_tile.cuh`) through an aux-chunked T buffer, plus a t reduction (skipped in the exchange-only flip mode; the virtual panel may come from a second tensor) |
| `grid_rho1`   | `response/sigma_df.py:495` `_fxc.rho1`, `:857`/`:1105` the flip transition density | `grid_rho1`   | the two GEMMs of the GGA minimum (tmp = z pv_0, u = z^T po_0) on the tile core, each contracted with the MO table in a tile epilogue, one launch per point span; four components or the value alone (one GEMM: the one of fewer rows); the meta-GGA tau row as three more GEMMs z pv_y dotted with po_y; second table likewise |
| `grid_back`   | `response/sigma_df.py:525` `_fxc.back`, `:861`/`:1113` the flip back-projection | `grid_back`   | one GEMM on the tile core, F formed in shared memory, one launch per point span; four components or the value alone; the meta-GGA tau term as a fifth weight row in F; second table likewise |
| `stda_coupling` | `stda/core.py:294` `_j_block`, `:323` the Coulomb diagonal of `csf_diagonal` | `stda_coupling` | a tile of J per block, its index lists (made once per CSF set on the device) in shared memory, the two small tables read in place (no gathered copies), J subtracted in place from the coupling matrix's block; the diagonal as a flat loop |

`df_exchange` also runs the RPA exchange of a TDHF sigma's B half
(`sigma_df.py:459` `_k2`), in the cheaper of two contraction orders, on an
aligned copy of one spin's ov block made once per operator: two GEMMs per
aux chunk with the aux index folded into their extents, on the TMA-fed
core of `csrc/tma_gemm.cuh` (a producer warp filling a ring of swizzled
shared-memory stages under mbarriers, eight consumer warps on DMMA or f32
FMA, persistent blocks over tiles and k splits).

The tile core runs f64 on the DMMA tensor cores (`mma.sync` m16n8k8) and
f32 as register-tiled FMA, with `cp.async` staging.  Every wrapper runs its
plain torch version on CPU tensors, launches its kernel on CUDA tensors (or
raises), and counts its launches in the module's ``launches`` integer, and
those of its exchange-only or RPA exchange (K1), meta-GGA tau (K2, K3) or
diagonal (K4) mode also in ``mode_launches``.
"""

from xtddft_tpu_torch.kernels import df_exchange, grid_back, grid_rho1, stda_coupling

MODULES = (df_exchange, grid_rho1, grid_back, stda_coupling)
# the kernels of every DF sigma build and DF Fock build (K4 runs in sTDA alone)
DF_MODULES = (df_exchange, grid_rho1, grid_back)


def launch_counts() -> dict[str, int]:
    return {m.NAME: m.launches for m in MODULES}


def mode_launch_counts() -> dict[str, int]:
    """The launches of the modes each wrapper counts apart, as
    "<kernel>.<mode>": K1's exchange-only and RPA exchange modes, K2's tau
    row, K3's tau term, K4's diagonal."""
    return {f"{m.NAME}.{k}": n for m in MODULES for k, n in m.mode_launches.items()}


def reset_launch_counts() -> None:
    for m in MODULES:
        m.launches = 0
        for k in m.mode_launches:
            m.mode_launches[k] = 0


def build_all() -> None:
    """Compile every kernel library (at first use this is what builds), one
    compiler process per source, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    from xtddft_tpu_torch.kernels import _cuda

    with ThreadPoolExecutor(len(MODULES)) as pool:
        for f in [pool.submit(_cuda.load, m.NAME, m._ARGS) for m in MODULES]:
            f.result()


__all__ = ["MODULES", "DF_MODULES", "launch_counts", "mode_launch_counts", "reset_launch_counts",
           "build_all"]

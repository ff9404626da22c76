"""Operations and bytes of a sigma build, and the table of the card's peaks.

A frozen copy of the port's `xtddft_tpu_torch/response/flops.py` (the
per-kernel counts, at the least a kernel's work needs), with the build's
other terms (Coulomb, Fock) added, so that a roofline share reads the same
work whatever implements it.  A least time is the larger of operations
over the peak rate and bytes over the memory rate, with every input read
once and every output written once.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 at its 700 W limit (data sheet, dense, no sparsity): f64
# on the tensor cores (DMMA) and f32 FMA (TF32 stays off) both 67 TFLOP/s
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float64": 8, "float32": 4}


def least_s(flops: float, nbytes: float, dtype_name: str) -> float:
    """The least seconds the card needs for ``flops`` and ``nbytes``."""
    return max(flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_PER_S)


# ---- the kernels (copied from the port's response/flops.py)

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


def grid_back_flops(nz, nocc, nvir, npts, ncomp=4):
    """K3 at its least: per vector and point 4*nocc*nvir + 6*nocc + 8*nvir
    for a GGA (ncomp 4), 2*nocc*nvir + nocc for the value alone (ncomp 1)."""
    if ncomp == 1:
        return 1.0 * nz * npts * (2 * nocc * nvir + nocc)
    return 2.0 * nz * npts * (2 * nocc * nvir + 3 * nocc + 4 * nvir)


def grid_back_bytes(nz, nocc, nvir, npts, itemsize, ncomp=4):
    """K3: the table's rows of o and v, the weighted potentials read; out read
    and written once (it accumulates)."""
    reads = min(ncomp, 4) * npts * (nocc + nvir) + ncomp * nz * npts + nz * nocc * nvir
    return float(itemsize) * (reads + nz * nocc * nvir)


def grid_rho1_flops(nz, nocc, nvir, npts, ncomp=4):
    """K2 at its least: per vector and point 4*nocc*nvir + 8*nocc + 6*nvir
    for a GGA (ncomp 4), 2*nocc*nvir + 2*nocc for the value alone."""
    if ncomp == 1:
        return 2.0 * nz * npts * (nocc * nvir + nocc)
    return 2.0 * nz * npts * (2 * nocc * nvir + 4 * nocc + 3 * nvir)


def grid_rho1_bytes(nz, nocc, nvir, npts, itemsize, ncomp=4, masked=True):
    """K2: the table's rows of o and v, z and the mask read; (nz, ncomp, g)
    written."""
    reads = min(ncomp, 4) * npts * (nocc + nvir) + nz * nocc * nvir + (npts if masked else 0)
    return float(itemsize) * (reads + ncomp * nz * npts)


# ---- one sigma build

@dataclasses.dataclass(frozen=True)
class Shapes:
    """What a build's work depends on: the method ("xtda" or "xsf"), the
    orbital partition, the aux and grid sizes, the dtype's name.  The
    functionals are global hybrids, so every build has its exchange; a
    flip build's per-point kernel is ALDA0's (one component)."""
    method: str
    nc: int
    no: int
    nv: int
    naux: int
    ngrid: int
    dtype: str

    @property
    def blocks(self):
        """(nocc, nvir) of each block a build contracts."""
        if self.method == "xtda":
            return ((self.nc + self.no, self.nv), (self.nc, self.no + self.nv))
        return ((self.nc + self.no, self.no + self.nv),)


def build_work(s: Shapes, nz: int) -> dict:
    """{part: (flops, bytes)} of one build of ``nz`` vectors: "k1" (the
    exchange, and t for X-TDA), "coulomb" (J = B_ov t), "grid" (K2 and K3:
    the fxc's two grid contractions), "fock" (z F_vv - F_oo z)."""
    it = ITEMSIZE[s.dtype]
    xtda = s.method == "xtda"
    ncomp = 4 if xtda else 1
    out = {"k1": [0.0, 0.0], "coulomb": [0.0, 0.0], "grid": [0.0, 0.0], "fock": [0.0, 0.0]}
    for o, v in s.blocks:
        out["k1"][0] += df_exchange_flops(s.naux, nz, o, v, with_t=xtda)
        out["k1"][1] += df_exchange_bytes(s.naux, nz, o, v, it, with_t=xtda)
        if xtda:
            out["coulomb"][0] += 2.0 * s.naux * o * v * nz
            out["coulomb"][1] += it * (s.naux * o * v + s.naux * nz + nz * o * v)
        out["grid"][0] += (grid_rho1_flops(nz, o, v, s.ngrid, ncomp)
                           + grid_back_flops(nz, o, v, s.ngrid, ncomp))
        out["grid"][1] += (grid_rho1_bytes(nz, o, v, s.ngrid, it, ncomp, masked=xtda)
                           + grid_back_bytes(nz, o, v, s.ngrid, it, ncomp))
        out["fock"][0] += 2.0 * nz * o * v * (o + v)
        out["fock"][1] += it * (o * o + v * v + 2 * nz * o * v)
    return {k: tuple(v) for k, v in out.items()}


def build_least_s(s: Shapes, nz: int, parts=None) -> float:
    """Least seconds of one build (or of its ``parts``): the parts' summed
    operations and bytes against the peaks."""
    work = build_work(s, nz)
    keys = parts if parts is not None else tuple(work)
    return least_s(sum(work[k][0] for k in keys), sum(work[k][1] for k in keys), s.dtype)

"""grid.roofline: K2 grid_rho1 and K3 grid_back together, the fxc's two grid
contractions: their least time for the work of the shapes they were given
(the frozen counts), over their device time in the traced solves, in
percent.  Layer: kernels (kernels/grid_rho1.py, grid_back.py, their .cu)."""

from xbench import counts

# the kernels of csrc/grid_rho1.cu and csrc/grid_back.cu as the profiler
# names them: their GEMMs on the tile core and K2's fixed-order slot sum
PATTERNS = ("Rho1Gemm", "sum_slots_kernel", "GridBack")


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(s for name, s in ctx.trace.kernels.items() if any(p in name for p in PATTERNS))
    if t <= 0.0:
        return None
    least = sum(counts.build_least_s(ctx.shapes, nz, ("grid",)) for _, nz in ctx.traced_builds)
    return 100.0 * least / t

"""k1.roofline: K1 df_exchange's least time for the work of the shapes it
was given (exchange, and t for X-TDA: the frozen counts of the port's
response/flops.py), over K1's device time in the traced solves, in
percent.  Layer: kernels (kernels/df_exchange.py, csrc/df_exchange.cu)."""

from xbench import counts

# the kernels of csrc/df_exchange.cu as the profiler names them: the
# Coulomb t reduction, the two GEMMs on the tile core, the fixed-order sum
PATTERNS = ("coulomb_t_kernel", "HalfTransform", "ExchangeBack", "sum_slices_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(s for name, s in ctx.trace.kernels.items() if any(p in name for p in PATTERNS))
    if t <= 0.0:
        return None
    least = sum(counts.build_least_s(ctx.shapes, nz, ("k1",)) for _, nz in ctx.traced_builds)
    return 100.0 * least / t

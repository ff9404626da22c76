"""solve.mfu: the whole solve's share of the card's peak, in percent: the
operations of every build of the window's solves (the frozen counts:
exchange and t, Coulomb, the fxc's two grid contractions, the Fock terms)
over the solves' wall time (operator set-up and Davidson, host clock, no
profiler) at the peak rate.  It bounds what a change to one kernel can claim.  Layer: solve."""

from xbench import counts


def read(ctx):
    wall = sum(r["operator_s"] + r["davidson_s"] for r in ctx.records)
    if wall <= 0.0:
        return None
    flops = sum(sum(f for f, _ in counts.build_work(ctx.shapes, nz).values())
                for _, nz in ctx.builds)
    return 100.0 * flops / (wall * counts.PEAK_FLOPS[ctx.shapes.dtype])

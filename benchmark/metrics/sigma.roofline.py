"""sigma.roofline: the builds' least time over their time, in percent.
The least time of a build is its work (the exchange and t, Coulomb, the
fxc's two grid contractions, the Fock terms at its vector count; the
benchmark's frozen counts) against the card's peaks; the time is the
host clock's sigma.ms.  It reads the same work whatever implements it.
Layer: sigma build."""

from xbench import counts


def read(ctx):
    builds = ctx.builds
    if not builds:
        return None
    least = sum(counts.build_least_s(ctx.shapes, nz) for _, nz in builds)
    return 100.0 * least / sum(s for s, _ in builds)

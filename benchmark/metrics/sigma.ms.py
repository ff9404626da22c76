"""sigma.ms: the mean milliseconds of one sigma build (the operator's
matvec: response/sigma_df.py, its kernels K1-K3, the Fock and dA terms),
host clock around each build, synchronised on both sides.  Layer: sigma
build."""


def read(ctx):
    t = [s for s, _ in ctx.builds]
    return 1e3 * sum(t) / len(t) if t else None

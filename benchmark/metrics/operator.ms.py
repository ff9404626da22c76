"""operator.ms: the mean milliseconds of a solve's operator set-up (the
sigma constructor of response/sigma_df.py with its diagonal, the guess,
and for SA > 0 the dA tensors of response/xsf_terms.py), host clock,
synchronised.  Layer: operator set-up."""


def read(ctx):
    t = [r["operator_s"] for r in ctx.records]
    return 1e3 * sum(t) / len(t) if t else None

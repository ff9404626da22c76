"""davidson.self_ms: the mean milliseconds per solve that solver/davidson.py
spends outside its sigma builds (orthogonalisation, the projections, the
host pencil, the residuals), host clock.  Layer: Davidson."""


def read(ctx):
    t = [r["davidson_s"] - sum(s for s, _ in r["builds"]) for r in ctx.records]
    return 1e3 * sum(t) / len(t) if t else None

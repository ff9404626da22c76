"""davidson.builds: sigma builds per solve, counted at the operator's
matvec that solver/davidson.py calls.  Layer: Davidson."""


def read(ctx):
    n = [len(r["builds"]) for r in ctx.records]
    return sum(n) / len(n) if n else None

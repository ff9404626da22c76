"""device.idle: the share of the traced solves' wall time with no kernel,
copy or memset on the card, in percent, from the profiler's trace.  The
profiler slows the host's dispatch, so on a host-paced build this reads
above the untraced window's idle share.  Layer: device."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

"""The device's idle share of the traced window (%): the time in which
no kernel, copy or fill ran on the card, from the profiler's trace.
Nothing to read where the trace holds no device operation."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""The card's idle share of the traced sub-window: 1 - (union of its
operations' intervals) / (the sub-window), in %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

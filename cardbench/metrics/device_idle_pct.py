"""The card's idle share of the traced window: the time in which no
kernel, copy or set ran on it (the complement of the union of the
profiler's device intervals), in percent."""


def read(ctx):
    if ctx.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.busy_s() / ctx.window_s)

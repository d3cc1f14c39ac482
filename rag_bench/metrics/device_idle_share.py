"""Device: the share of the traced sub-window's wall time in which no
operation ran on the card (the profiler's device intervals, unioned)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])

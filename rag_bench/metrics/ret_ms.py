"""Retrieval: mean host-clock time of a ``search_charged`` call (one
retrieval sub-stage: device scan of the hot clusters, host scan of the
rest, merge), over every call in the window."""


def read(ctx):
    d = ctx.durations("ret")
    return 1e3 * sum(d) / len(d) if d else None

"""Kernels: ``ivf_scan``'s share of its roofline in the traced sub-window:
the bytes of each call (the distinct probed clusters' valid rows, the query
groups, ids and output; ``harness/peaks``) at 3.35 TB/s, over the profiler's
device time of its launches.  Nothing to read where no call fell in the
sub-window or the launches do not match the calls."""
from rag_bench.harness.peaks import HBM_BYTES_PER_S


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.scan_calls:
        return None
    n, secs = t["kernels"]["ivf_scan"]
    if n != len(ctx.scan_calls) or secs <= 0:
        return None
    return 100.0 * sum(ctx.scan_calls) / HBM_BYTES_PER_S / secs

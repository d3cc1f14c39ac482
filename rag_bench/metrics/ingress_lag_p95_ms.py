"""Ingress: 95th percentile over the window's arrivals of the producer's put
stamp minus the arrival's due instant (how late the generator ran); in a
traced run the arrivals due while the profiler starts or stops are left
out."""
from rag_bench.harness.stats import percentile


def read(ctx):
    w = ctx.window
    lags = [w.put[t] - w.due[t] for t in ctx.arrivals() if t in w.put]
    return 1e3 * percentile(lags, 95) if lags else None

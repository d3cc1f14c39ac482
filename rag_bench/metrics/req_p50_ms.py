"""Median latency of every request due in the window, from its due instant
to its last stage's completion (unfinished requests timed to the drain's
end; they also fail the run)."""
from rag_bench.harness.stats import percentile


def read(ctx):
    return 1e3 * percentile(ctx.latencies, 50) if ctx.latencies else None

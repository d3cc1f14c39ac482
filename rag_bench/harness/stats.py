"""The statistics the benchmark reports, over whole windows: no rate or tail
is taken from medians of chunks, so a stall shows."""
from __future__ import annotations

import statistics

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (linear interpolation, numpy's default) of all
    ``values``; NaN when there are none."""
    v = np.asarray(list(values), np.float64)
    return float(np.percentile(v, q)) if v.size else float("nan")


def latencies(window) -> tuple[list, int]:
    """Each request due in the window, timed from its due instant to the
    pump's notice of its last stage's completion; a request not finished by
    the end of the drain counts as failed and is timed to the drain's end.
    Returns (seconds of each due request, failed)."""
    out, failed = [], 0
    for text, due in window.due.items():
        done = window.done.get(text)
        if done is None:
            failed += 1
            done = window.drained_at
        out.append(done - due)
    return out, failed


def spread(values) -> float:
    """The distance between the first and third quartile (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total

"""The percentile arithmetic over whole windows: a stall shows in the tail,
and an unfinished request fails and is timed to the
drain's end."""
from __future__ import annotations

import statistics

import pytest

from rag_bench.harness.serve import Window
from rag_bench.harness.stats import latencies, percentile, spread, union_length


def stalled_window():
    # 100 requests due 0.1 s apart, each served in 0.05 s, except that a
    # stall holds the six due in [5, 5.6) until 7 s
    due = {f"r{j}": 0.1 * j for j in range(100)}
    done = {}
    for t, d in due.items():
        done[t] = 7.0 if 5.0 <= d < 5.55 else d + 0.05
    done.pop("r99")  # never finished
    return Window(t0=0.0, seconds=10.0, due=due, put=dict(due), done=done, drained_at=12.0,
                  timed_out=True)


def test_latencies_time_every_due_request_and_fail_the_unfinished():
    lat, failed = latencies(stalled_window())
    assert failed == 1 and len(lat) == 100
    assert max(lat) == pytest.approx(12.0 - 9.9)


def test_tail_sees_the_stall_where_chunk_medians_would_not():
    lat, _ = latencies(stalled_window())
    p50, p95 = percentile(lat, 50), percentile(lat, 95)
    assert p50 == pytest.approx(0.05)
    assert p95 > 1.0  # six stalled and one unfinished of 100 reach the 95th percentile
    chunks = [statistics.median(lat[i:i + 20]) for i in range(0, 100, 20)]
    assert max(chunks) == pytest.approx(0.05, abs=1e-9)


def test_percentile_interpolates_and_spread_uses_python_quartiles():
    assert percentile([1, 2, 3, 4], 50) == 2.5
    assert percentile([], 95) != percentile([], 95)  # NaN
    v = [10, 11, 12, 13, 14, 15]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / 12.5)


def test_union_length_merges_overlaps():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4

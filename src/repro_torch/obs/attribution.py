"""Per-request latency attribution / critical-path analysis.

Each finished request's measured latency (``finish - arrival`` on the
virtual clock) is decomposed into exhaustive, non-overlapping components
using the categorized intervals the :class:`~repro_torch.obs.trace.TraceRecorder`
collected:

``queueing``
    time covered by no span at all — waiting in the admission heap, for a
    batch slot, or for a busy worker;
``retrieval_compute`` / ``generation_compute`` / ``stage_compute``
    time the request was (co-)resident in a retrieval scan, a generation
    batch, or a host stage batch;
``merge``
    shard scatter/gather k-way merge points (zero-width on the virtual
    clock — the merge is charged to the part scans — kept as a component
    so the decomposition names every structural step);
``retry_hedge_failover``
    backoff gaps between a transiently failed / timed-out unit and its
    re-dispatch;
``fault_recovery``
    compute lost to a dead worker (fenced results) plus the gap until the
    replacement dispatch.

The decomposition is a *priority sweep* over elementary segments: every
interval boundary inside ``[arrival, finish]`` splits the timeline, each
elementary segment is charged to the single highest-priority component
covering it (compute beats overhead beats recovery; uncovered segments are
queueing), so the components partition the latency exactly — their sum
equals the measured latency by construction, up to float rounding.  The
run-level report (``Server.attribution_report()``) verifies that residual
against a relative tolerance and aggregates totals, fractions and the
per-workflow bottleneck component.
"""
from __future__ import annotations

from typing import Optional

ATTRIBUTION_COMPONENTS = (
    "queueing",
    "retrieval_compute",
    "generation_compute",
    "stage_compute",
    "merge",
    "retry_hedge_failover",
    "fault_recovery",
)

# a segment covered by several span categories is charged to the highest
# priority: actual compute > structural overhead > recovery wait.  Uncovered
# segments fall through to queueing.
_PRIORITY = {
    "generation_compute": 6,
    "retrieval_compute": 5,
    "stage_compute": 4,
    "merge": 3,
    "retry_hedge_failover": 2,
    "fault_recovery": 1,
}


def sweep(intervals, start_us: float, end_us: float) -> dict:
    """Priority sweep of ``[start, end, component]`` rows clipped to
    ``[start_us, end_us]``.  Returns ``{component: us}`` over *all*
    components (zeros included) whose values sum to ``end_us - start_us``
    exactly (up to float rounding)."""
    out = {c: 0.0 for c in ATTRIBUTION_COMPONENTS}
    start_us = float(start_us)
    end_us = float(end_us)
    if end_us <= start_us:
        return out
    clipped = []
    cuts = {start_us, end_us}
    for row in intervals:
        s, e, comp = float(row[0]), float(row[1]), row[2]
        s = max(s, start_us)
        e = min(e, end_us)
        if e <= s:
            continue
        clipped.append((s, e, comp))
        cuts.add(s)
        cuts.add(e)
    bounds = sorted(cuts)
    for a, b in zip(bounds[:-1], bounds[1:]):
        best = None
        for s, e, comp in clipped:
            if s <= a and e >= b:
                if best is None or _PRIORITY[comp] > _PRIORITY[best]:
                    best = comp
        out[best if best is not None else "queueing"] += b - a
    return out


def attribute_request(entry) -> Optional[dict]:
    """Decompose one finished request (a ``TraceRecorder`` per-request
    entry).  Returns None for a request that never finished."""
    if entry.finish_us is None:
        return None
    latency = float(entry.finish_us) - float(entry.arrival_us)
    comps = sweep(entry.intervals, entry.arrival_us, entry.finish_us)
    total = sum(comps.values())
    residual = abs(total - latency)
    rel = residual / latency if latency > 0 else residual
    return {
        "request": entry.rid,
        "workflow": entry.workflow,
        "arrival_us": float(entry.arrival_us),
        "finish_us": float(entry.finish_us),
        "latency_us": latency,
        "degraded": bool(entry.degraded),
        "components_us": comps,
        "residual_us": residual,
        "rel_residual": rel,
    }


def attribution_report(recorder, *, check: bool = True,
                       rel_tol: float = 1e-6) -> dict:
    """Run-level attribution over every finished request in ``recorder``.

    With ``check=True`` (the default) raises ``ValueError`` if any
    request's components fail to sum to its measured latency within
    ``rel_tol`` relative tolerance — the decomposition is exhaustive by
    construction, so a violation means the recorder missed a span.
    """
    rows = []
    for rid in sorted(recorder.requests):
        row = attribute_request(recorder.requests[rid])
        if row is not None:
            rows.append(row)
    max_rel = max((r["rel_residual"] for r in rows), default=0.0)
    if check and max_rel > rel_tol:
        worst = max(rows, key=lambda r: r["rel_residual"])
        raise ValueError(
            f"attribution residual {worst['rel_residual']:.3e} for request "
            f"{worst['request']} exceeds rel_tol={rel_tol:.1e} "
            f"(components {worst['components_us']}, "
            f"latency {worst['latency_us']})")

    totals = {c: 0.0 for c in ATTRIBUTION_COMPONENTS}
    by_wf: dict[str, dict] = {}
    for r in rows:
        for c, v in r["components_us"].items():
            totals[c] += v
        wf = by_wf.setdefault(r["workflow"], {
            "finished": 0, "latency_us": 0.0,
            "components_us": {c: 0.0 for c in ATTRIBUTION_COMPONENTS},
        })
        wf["finished"] += 1
        wf["latency_us"] += r["latency_us"]
        for c, v in r["components_us"].items():
            wf["components_us"][c] += v
    grand = sum(totals.values())
    n = len(rows)
    for wf in by_wf.values():
        tot = max(sum(wf["components_us"].values()), 1e-12)
        wf["fractions"] = {c: v / tot
                           for c, v in wf["components_us"].items()}
        wf["bottleneck"] = max(wf["components_us"],
                               key=lambda c: wf["components_us"][c])
        wf["mean_latency_us"] = wf["latency_us"] / max(wf["finished"], 1)
    return {
        "finished": n,
        "totals_us": totals,
        "fractions": {c: (v / grand if grand > 0 else 0.0)
                      for c, v in totals.items()},
        "means_us": {c: (v / n if n else 0.0) for c, v in totals.items()},
        "bottleneck": max(totals, key=lambda c: totals[c]) if n else None,
        "by_workflow": {k: by_wf[k] for k in sorted(by_wf)},
        "max_rel_residual": max_rel,
        "rel_tol": rel_tol,
        "per_request": rows,
    }

"""End-to-end observability for the serving runtime.

Three layers, all default-off and purely passive (enabling them never
changes a scheduling decision, an RNG draw, or a per-request event trace):

* ``obs.trace`` — a span tracer that turns the scheduler's dispatched jobs
  and per-request ``(t, event, payload)`` tuples into a Chrome
  trace-event / Perfetto JSON timeline: one track per resource (gen
  engine, each retrieval worker, the admission queue) with flow events for
  sub-stage dependencies, hedge duplicates, shard scatter/gather fan-out,
  dedup leader→follower fusion, and failover re-dispatch.
* ``obs.registry`` — a labeled metrics registry (counters / gauges /
  histograms with ``worker`` / ``stage_kind`` / ``workflow`` /
  ``slo_class`` labels) layered around the load-bearing ``Metrics``
  dataclass, plus a virtual-clock sampler for queue depth, per-worker
  utilization, and lifecycle states; rendered as a Prometheus-style text
  snapshot.
* ``obs.attribution`` — a latency attribution / critical-path analyzer
  that decomposes each finished request into queueing, retrieval compute,
  generation compute, stage compute, merge, retry/hedge/failover overhead,
  and fault-recovery time — components sum to the measured latency by
  construction.

Enable through the scheduler knobs (``tracing=True`` / ``telemetry=True``)
and read through ``Server.export_trace()`` / ``Server.metrics_snapshot()``
/ ``Server.attribution_report()``.
"""
from repro_torch.obs.attribution import (  # noqa: F401
    ATTRIBUTION_COMPONENTS,
    attribute_request,
    attribution_report,
)
from repro_torch.obs.registry import MetricsRegistry, TelemetrySampler  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    TraceRecorder,
    request_ids_in_trace,
    validate_trace,
)

"""Labeled metrics registry + virtual-clock telemetry sampler.

The registry is a small Prometheus-flavoured metric store (counters,
gauges, histograms, each with declared label names) layered *around* the
scheduler's load-bearing ``Metrics`` dataclass — the dataclass stays the
single source of truth for scheduling-side counters; the registry is a
read-only projection of it plus the periodic samples the dataclass cannot
hold (queue depth, per-worker utilization, lifecycle state populations,
pending-heap size over virtual time).

* :class:`MetricsRegistry` — ``counter()`` / ``gauge()`` / ``histogram()``
  families with ``.labels(**kw)`` children, rendered either as a
  Prometheus text-exposition snapshot (``render()``) or a JSON-safe
  structured snapshot with a schema-version field (``snapshot()``).
* :class:`TelemetrySampler` — attached by ``SchedulerConfig.telemetry``;
  ``maybe_sample()`` fires at ``telemetry_interval_us`` boundaries of the
  *virtual* clock inside the scheduler cycle, and per-event hooks
  (``on_finish`` / ``on_ret_job`` / ``on_gen_job``) feed the labeled
  families.  ``finalize()`` folds the ``Metrics`` dataclass counters in at
  the end of a run.

Everything here is passive: sampling reads scheduler state, never mutates
it, and draws no randomness — telemetry-on runs are bit-identical to
telemetry-off runs.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.ownership import handoff, owned_by

SNAPSHOT_SCHEMA_VERSION = 1

# log-spaced latency buckets in virtual microseconds: 1 ms .. 10 s
DEFAULT_BUCKETS_US = (
    1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4, 1e5, 2.5e5, 5e5,
    1e6, 2.5e6, 5e6, 1e7,
)


def _escape(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt(value: float) -> str:
    f = float(value)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Family:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.children: dict[tuple, object] = {}

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(kw))}")
        key = tuple(str(kw[k]) for k in self.labelnames)
        child = self.children.get(key)
        if child is None:
            child = self._make_child()
            self.children[key] = child
        return child

    def _default_child(self):
        """The no-label singleton child (valid only when labelnames=())."""
        return self.labels()

    def _make_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _sorted_children(self):
        return sorted(self.children.items())

    def _labels_of(self, key: tuple) -> dict:
        return dict(zip(self.labelnames, key))


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += float(amount)


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)

    def render(self) -> list[str]:
        return [f"{self.name}{_label_str(self._labels_of(k))} "
                f"{_fmt(c.value)}"
                for k, c in self._sorted_children()]

    def sample_dicts(self) -> list[dict]:
        return [{"labels": self._labels_of(k), "value": c.value}
                for k, c in self._sorted_children()]


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += float(amount)


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)

    def render(self) -> list[str]:
        return [f"{self.name}{_label_str(self._labels_of(k))} "
                f"{_fmt(c.value)}"
                for k, c in self._sorted_children()]

    def sample_dicts(self) -> list[dict]:
        return [{"labels": self._labels_of(k), "value": c.value}
                for k, c in self._sorted_children()]


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1

    def cumulative(self) -> list[int]:
        return list(self.counts)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 buckets: tuple = DEFAULT_BUCKETS_US):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float, **labels) -> None:
        self.labels(**labels).observe(value)

    def render(self) -> list[str]:
        out = []
        for k, c in self._sorted_children():
            base = self._labels_of(k)
            for le, n in zip(self.buckets, c.cumulative()):
                out.append(
                    f"{self.name}_bucket"
                    f"{_label_str(dict(base, le=_fmt(le)))} {n}")
            out.append(f"{self.name}_bucket"
                       f"{_label_str(dict(base, le='+Inf'))} {c.count}")
            out.append(f"{self.name}_sum{_label_str(base)} {_fmt(c.sum)}")
            out.append(f"{self.name}_count{_label_str(base)} {c.count}")
        return out

    def sample_dicts(self) -> list[dict]:
        return [{"labels": self._labels_of(k),
                 "buckets": {_fmt(le): n for le, n in
                             zip(self.buckets, c.cumulative())},
                 "sum": c.sum, "count": c.count}
                for k, c in self._sorted_children()]


class MetricsRegistry:
    """Declared metric families addressed by name; one instance per server."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _register(self, fam: _Family) -> _Family:
        have = self._families.get(fam.name)
        if have is not None:
            if type(have) is not type(fam):
                raise ValueError(
                    f"metric {fam.name!r} already registered as {have.kind}")
            return have
        self._families[fam.name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS_US) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))

    def render(self) -> str:
        """Prometheus text exposition format (sorted by metric name)."""
        lines: list[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-safe structured snapshot (stable key order)."""
        return {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "metrics": {
                name: {
                    "type": fam.kind,
                    "help": fam.help,
                    "labelnames": list(fam.labelnames),
                    "samples": fam.sample_dicts(),
                }
                for name, fam in sorted(self._families.items())
            },
        }


def slo_class_of(slo_us) -> str:
    """Stable label value for a request's SLO tier (the workload layer keys
    tiers by their microsecond budget, so the budget *is* the class)."""
    if not slo_us or float(slo_us) <= 0 or float(slo_us) == float("inf"):
        return "none"
    return f"{int(float(slo_us))}us"


@owned_by("obs")
class TelemetrySampler:
    """Virtual-clock sampler driven from the scheduler cycle.

    ``maybe_sample(sched, now)`` records one sample row per elapsed
    ``interval_us`` boundary (queue depth, active count, per-worker
    utilization, pending-heap size, lifecycle state populations, gen
    utilization) and mirrors the latest values into registry gauges;
    ``on_*`` hooks feed labeled counters/histograms as events happen.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_us: float = 50_000.0):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.interval_us = max(float(interval_us), 1.0)
        self.samples: list[dict] = []
        self._next_sample_us = 0.0
        r = self.registry
        self.m_pending = r.gauge(
            "repro_pending_depth",
            "requests queued for admission (pending heap size)")
        self.m_active = r.gauge(
            "repro_active_requests", "requests admitted and in flight")
        self.m_worker_util = r.gauge(
            "repro_worker_utilization",
            "per-worker completed-busy fraction of virtual time",
            labelnames=("worker",))
        self.m_gen_util = r.gauge(
            "repro_gen_utilization",
            "gen-engine busy fraction of virtual time")
        self.m_lifecycle = r.gauge(
            "repro_workers_by_state",
            "retrieval workers per lifecycle state",
            labelnames=("state",))
        self.m_samples = r.counter(
            "repro_telemetry_samples_total", "telemetry sample rows taken")
        self.m_finished = r.counter(
            "repro_requests_finished_total",
            "finished requests by workflow and SLO tier",
            labelnames=("workflow", "slo_class"))
        self.m_latency = r.histogram(
            "repro_request_latency_us",
            "end-to-end request latency (virtual us)",
            labelnames=("workflow", "slo_class"))
        self.m_shed = r.counter(
            "repro_requests_shed_total", "requests shed at admission",
            labelnames=("reason",))
        self.m_ret_jobs = r.counter(
            "repro_ret_jobs_total",
            "retrieval-side dispatches by worker and stage kind",
            labelnames=("worker", "stage_kind"))
        self.m_gen_jobs = r.counter(
            "repro_gen_jobs_total", "generation batches dispatched")
        self.m_sched = r.gauge(
            "repro_scheduler_counter",
            "Metrics dataclass counters folded at end of run",
            labelnames=("name",))
        # wall-clock ingress track (serving/ingress.py): the loop hands the
        # wall/virtual clock values in as arguments — obs never reads time
        self.wall_samples: list[dict] = []
        self.m_ingress_rows = r.counter(
            "repro_ingress_rows_total",
            "ingress trace rows applied by kind",
            labelnames=("kind",))
        self.m_ingress_depth = r.gauge(
            "repro_ingress_queue_depth",
            "producer->scheduler queue occupancy at last wall sample")
        self.m_clock_drift = r.gauge(
            "repro_ingress_clock_drift_us",
            "wall clock minus event clock at last wall sample (virtual us)")

    # ----------------------------------------------------------- event hooks
    @handoff("scheduler")
    def on_finish(self, req, now: float) -> None:
        wf = req.graph.name
        sc = slo_class_of(req.slo_us)
        self.m_finished.inc(workflow=wf, slo_class=sc)
        self.m_latency.observe(float(now) - float(req.arrival_us),
                               workflow=wf, slo_class=sc)

    @handoff("scheduler")
    def on_shed(self, req, reason: str) -> None:
        self.m_shed.inc(reason=str(reason))

    @handoff("scheduler")
    def on_ret_job(self, job, wid: int) -> None:
        kinds: dict[str, int] = {}
        plan = job.get("plan")
        if plan is not None:
            for meta in plan.group_meta:
                kinds[meta[0]] = kinds.get(meta[0], 0) + 1
        for task, _fn in job.get("tasks", ()):
            kinds[task.kind] = kinds.get(task.kind, 0) + 1
        for kind, n in kinds.items():
            self.m_ret_jobs.inc(n, worker=str(int(wid)), stage_kind=kind)

    @handoff("scheduler")
    def on_gen_job(self, job) -> None:
        self.m_gen_jobs.inc()

    @handoff("server")
    def on_ingress_row(self, kind: str) -> None:
        """One ingress trace row applied (arrival/heartbeat/readmit/tick)."""
        self.m_ingress_rows.inc(kind=str(kind))

    @handoff("server")
    def on_wall_sample(self, *, wall_us: float, virtual_us: float,
                       queue_depth: int, parked: int) -> None:
        """Periodic wall-clock tap from the ingress loop.  Passive and
        unrecorded: replayed runs simply have an empty wall track; the
        fingerprint contract is unaffected."""
        self.m_ingress_depth.set(float(queue_depth))
        self.m_clock_drift.set(float(wall_us) - float(virtual_us))
        self.wall_samples.append({
            "wall_us": float(wall_us),
            "virtual_us": float(virtual_us),
            "drift_us": float(wall_us) - float(virtual_us),
            "queue_depth": int(queue_depth),
            "parked": int(parked),
        })

    # ------------------------------------------------------------- sampling
    @handoff("scheduler")
    def maybe_sample(self, sched, now: float) -> None:
        if now < self._next_sample_us:
            return
        self._sample(sched, now)
        # skip ahead past any idle gap: one sample per boundary crossed
        k = int((now - self._next_sample_us) // self.interval_us) + 1
        self._next_sample_us += k * self.interval_us

    def _sample(self, sched, now: float) -> None:
        t = max(float(now), 1e-9)
        pending = len(sched._pending)
        active = len(sched.active)
        util = sched.dispatcher.utilization(t)
        states = sched.lifecycle.state_counts()
        gen_util = sched.metrics.gen_busy_us / t
        self.m_pending.set(pending)
        self.m_active.set(active)
        self.m_gen_util.set(gen_util)
        for w, u in enumerate(util):
            self.m_worker_util.set(u, worker=str(w))
        for state, n in states.items():
            self.m_lifecycle.set(n, state=state)
        self.m_samples.inc()
        self.samples.append({
            "t_us": float(now),
            "pending": pending,
            "active": active,
            "gen_util": gen_util,
            "worker_util": [float(u) for u in util],
            "lifecycle": states,
        })

    @handoff("scheduler")
    def finalize(self, sched, now: float) -> None:
        """End-of-run fold: one last sample plus the ``Metrics`` dataclass
        scalar counters projected into ``repro_scheduler_counter``."""
        self._sample(sched, now)
        m = sched.metrics
        for name in sorted(vars(m)):
            v = getattr(m, name)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.m_sched.set(float(v), name=name)

    def snapshot(self) -> dict:
        snap = self.registry.snapshot()
        snap["interval_us"] = self.interval_us
        snap["timeline"] = list(self.samples)
        snap["wall_timeline"] = list(self.wall_samples)
        return snap

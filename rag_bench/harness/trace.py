"""The traced run's profiler: ``torch.profiler`` over a fixed steady
sub-window of the measured window, opened and closed by the pump thread
between scheduler steps.  From it: the device's busy time (the union of its
operations' intervals), device time by kernel name, each idle gap named by
the harness span open on the host at its middle, and the device time of
the kernels whose rooflines the benchmark reports.

Starting and stopping the profiler holds the pump thread (and with it the
producer, through the interpreter lock) for a while; the host-clock readings
of a traced run leave that interval out (``Context.excluded``)."""
from __future__ import annotations

import time

from .stats import union_length

# the sub-window: from START_SHARE of the window (at least 1 s in), for at
# most LENGTH_S seconds (a decode step of qwen3 is ~380 device ops, so 2 s
# of trace holds ~10^5 events); a second attempt from RETRY_SHARE
START_SHARE, LENGTH_S, RETRY_SHARE = 0.4, 2.0, 0.7

KERNEL_NAMES = {"decode_attention": "decode_attention_kernel", "ivf_scan": "ivf_scan_kernel"}


def _ns(e, end: bool) -> float:
    if hasattr(e, "start_ns"):
        return float(e.end_ns() if end else e.start_ns())
    return 1e3 * float(e.start_us() + (e.duration_us() if end else 0))


class Profiler:
    """Up to two attempts: where the first sub-window's trace holds no device
    operation (the profiler's device tracing did not take), a second opens
    at RETRY_SHARE of the window."""

    def __init__(self, torch, spans, t0: float, seconds: float):
        self.torch, self.spans = torch, spans
        self.t0, self.seconds = t0, seconds
        self.length = min(LENGTH_S, 0.3 * seconds)
        self.start_at = t0 + max(1.0, START_SHARE * seconds)
        self.prof = None
        self.attempts = 0
        self.started = self.stopped = None
        self.opened = self.closed = None  # the host time the profiler itself holds
        self.events = None  # the raw events of the attempt that traced the device

    def tick(self) -> None:
        """Called by the pump thread between steps."""
        now = time.monotonic()
        if self.prof is None and self.events is None and now >= self.start_at:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.attempts += 1
            if self.opened is None:
                self.opened = now
            self.prof.start()
            self.started = time.monotonic()
            self.spans.profiling = True
        elif self.prof is not None and now >= self.started + self.length:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        from torch.autograd import DeviceType

        self.spans.profiling = False
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.stop()
        self.stopped = time.monotonic()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        traced = any(e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                     for e in events)
        retry = self.t0 + RETRY_SHARE * self.seconds
        if traced or self.attempts >= 2 or retry + self.length > self.t0 + self.seconds:
            self.events = events if traced else []
        else:
            self.start_at = retry
        self.closed = time.monotonic()

    def read(self) -> dict | None:
        """What the trace holds, or None where no device op was traced."""
        if not self.events:
            return None
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in self.events:
            a, b, name = _ns(e, False), _ns(e, True), e.name()
            if name.startswith("rag_bench."):
                # the harness's spans: a CPU range, and its copy on the
                # device's timeline (a user annotation, not an operation)
                if e.device_type() != DeviceType.CUDA:
                    host.append((a, b, name[len("rag_bench."):]))
            elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                dev.append((a, b, name))
        if not dev:
            return None
        dev.sort()
        by_name: dict = {}
        for a, b, n in dev:
            s, c = by_name.get(n, (0.0, 0))
            by_name[n] = (s + (b - a) / 1e9, c + 1)
        busy = union_length([(a, b) for a, b, _ in dev]) / 1e9
        gaps, end = [], None
        for a, b, _ in dev:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host.sort(key=lambda h: h[1] - h[0])  # innermost (shortest) first
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (a + b) / 2
            name = next((n for ha, hb, n in host if ha <= mid <= hb), "pump outside the backend")
            named.append((name, (b - a) / 1e9))
        kernels = {}
        for key, sym in KERNEL_NAMES.items():
            hits = [(b - a) / 1e9 for a, b, n in dev if sym in n]
            kernels[key] = (len(hits), sum(hits))
        return {"busy_s": busy, "window_s": self.stopped - self.started, "by_name": by_name,
                "gaps": named, "kernels": kernels, "attempts": self.attempts}

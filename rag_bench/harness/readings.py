"""What a metric's reader reads: the window, the host-clock spans inside it,
the engine's admissions and decode steps, the cache's counters, and the
traced sub-window (``--trace 1``)."""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

from .stats import latencies

METRICS_DIR = Path(__file__).resolve().parents[1] / "metrics"


@dataclasses.dataclass
class Context:
    window: object  # serve.Window
    setup_s: float
    stack: object  # serve.Stack
    flops: object  # peaks.ModelFlops
    cache_delta: tuple  # (hits, misses) of the hot-cluster cache over the window
    trace: dict | None = None  # trace.Profiler.read()
    excluded: tuple = (0.0, 0.0)  # (from, to): the profiler's own start and stop

    def __post_init__(self):
        self.seconds = self.window.seconds - (self.excluded[1] - self.excluded[0])
        self.lo, self.hi = self.window.t0, self.window.t0 + self.window.seconds
        self.latencies = latencies(self.window)[0]
        s = self.stack
        self.step_lens, self.scan_calls = s.step_lens, s.scan_calls
        mc = s.mc
        # each decode_attention layer's window (a ring's rows; 0: the whole cache)
        self.attn_windows = [mc.local_window if g.mixer == "local_attn" else 0
                             for g in mc.segments if g.mixer in ("attn", "local_attn")
                             for _ in range(g.repeat)]
        self.attn_shape = (mc.n_kv_heads, mc.d_head, mc.n_heads, s.engine_batch)

    def _in(self, a: float) -> bool:
        return self.lo <= a < self.hi and not self.excluded[0] <= a < self.excluded[1]

    def arrivals(self) -> list:
        """The texts of the requests due in the window, outside ``excluded``."""
        return [t for t, due in self.window.due.items() if self._in(due)]

    def durations(self, name: str) -> list:
        return [b - a for n, a, b in self.stack.spans.rows if n == name and self._in(a)]

    def span_total(self, name: str) -> float:
        return sum(self.durations(name))

    def admissions(self) -> list:
        """(seconds, padded width) of each admission in the window."""
        return [(b - a, w) for a, b, w in self.stack.admits if self._in(a)]

    def decode_steps(self) -> list:
        """(seconds, context of each active sequence) of each decode step."""
        return [(b - a, c) for a, b, c in self.stack.steps if self._in(a)]


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the reader
    of its base name (the part before the first dot)."""
    for stem in (name, name.split(".")[0]):
        path = METRICS_DIR / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"rag_bench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in {METRICS_DIR}")

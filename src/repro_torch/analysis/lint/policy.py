"""Per-package policy for repro-lint.

Paths are posix-style and relative to the scan root (normally ``src/``), so
prefixes look like ``repro_torch/core/``.  Benchmarks, scripts, examples and
tests sit outside the scan root and are therefore exempt from every rule —
bench code in particular is *allowed* to read the wall clock (it measures
real time by design; see benchmarks/README.md).
"""
from __future__ import annotations

import dataclasses


def _match(relpath: str, prefixes: tuple) -> bool:
    return any(relpath == p or relpath.startswith(p) for p in prefixes)


@dataclasses.dataclass(frozen=True)
class Policy:
    # ---- registry discipline ------------------------------------------
    # stage kinds owned by the registry; keep in sync with
    # repro_torch.core.stages (tests/test_lint.py asserts the sync)
    stage_kinds: frozenset = frozenset(
        {"generation", "retrieval", "rerank", "rewrite", "compress"})
    # files allowed to branch on kind strings: the registry itself and the
    # node dataclass definitions
    kind_exempt: tuple = ("repro_torch/core/stages.py", "repro_torch/core/ragraph.py")

    # ---- determinism ---------------------------------------------------
    # packages where only the virtual clock may be read
    virtual_clock_paths: tuple = (
        "repro_torch/core/", "repro_torch/serving/", "repro_torch/crossreq/", "repro_torch/obs/")
    # the one carve-out inside those packages: the wall-clock ingress
    # boundary (serving/ingress.py) exists to *read* real time — producer
    # threads stamp arrivals/heartbeats there and everything downstream
    # consumes the recorded stamps.  Nothing else in the serving packages
    # may join this list; obs taps receive wall values as arguments.
    wallclock_ingress_paths: tuple = ("repro_torch/serving/ingress.py",)
    wallclock_calls: frozenset = frozenset({
        "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
        "time.perf_counter", "time.perf_counter_ns", "time.process_time",
        "time.process_time_ns",
        "datetime.datetime.now", "datetime.datetime.utcnow",
        "datetime.datetime.today", "datetime.date.today",
    })
    # module-level stdlib/numpy RNG entry points that draw from global or
    # entropy-seeded state (checked everywhere under the scan root)
    global_rng_calls: frozenset = frozenset({
        "random.random", "random.randint", "random.randrange",
        "random.shuffle", "random.choice", "random.choices",
        "random.sample", "random.uniform", "random.gauss",
        "random.normalvariate", "random.betavariate", "random.seed",
        "random.getrandbits",
        "numpy.random.rand", "numpy.random.randn", "numpy.random.randint",
        "numpy.random.random", "numpy.random.random_sample",
        "numpy.random.ranf", "numpy.random.sample",
        "numpy.random.shuffle", "numpy.random.permutation",
        "numpy.random.choice", "numpy.random.uniform",
        "numpy.random.normal", "numpy.random.standard_normal",
        "numpy.random.seed",
    })
    # constructors that *must* be seeded: flagged only with zero args
    seed_required_calls: frozenset = frozenset({
        "numpy.random.default_rng", "random.Random", "random.SystemRandom",
        "jax.random.PRNGKey",
    })
    # packages where hash-ordered iteration is checked
    set_iter_paths: tuple = (
        "repro_torch/core/", "repro_torch/serving/", "repro_torch/crossreq/", "repro_torch/obs/")
    # calls that make iteration order observable in scheduling decisions:
    # heap pushes, top-k folds, dispatch selection, admission
    ordering_sinks: frozenset = frozenset({
        "heappush", "heapify", "heappushpop", "heapreplace",
        "nlargest", "nsmallest",
        "pick_worker", "pick_shard_worker", "least_loaded",
        "add_request", "submit",
    })
    # known set-returning APIs in this codebase (syntactic, by method name)
    set_returning_calls: frozenset = frozenset({
        "covering_holders", "owners_for",
    })
    # loop-body statement calls that are order-insensitive folds: a loop
    # over a set whose body only accumulates into sets is deterministic
    order_insensitive_calls: frozenset = frozenset(
        {"add", "update", "discard"})

    # ---- hook passivity ------------------------------------------------
    obs_paths: tuple = ("repro_torch/obs/",)
    # the scheduler file whose hook callsites must be knob-guarded, and the
    # attributes holding the hook objects (None when the knob is off)
    hook_file: str = "repro_torch/core/wavefront.py"
    hook_attrs: tuple = ("obs", "telemetry")
    # method names that mutate their receiver — calling one of these on an
    # object passed *into* an obs hook is a passivity violation
    mutator_calls: frozenset = frozenset({
        "add", "append", "extend", "insert", "remove", "discard", "pop",
        "popleft", "popitem", "clear", "update", "setdefault", "sort",
        "reverse", "write", "inc", "dec", "set", "observe", "record",
        "reset", "push", "heappush", "submit", "step", "run", "drain",
        "cancel", "tick", "register", "readmit", "rebind",
        "add_request", "note_busy", "note_complete", "note_dispatch",
        "register_worker", "drain_worker", "rebind_worker",
    })

    def in_virtual_clock_zone(self, relpath: str) -> bool:
        if _match(relpath, self.wallclock_ingress_paths):
            return False
        return _match(relpath, self.virtual_clock_paths)

    def in_set_iter_zone(self, relpath: str) -> bool:
        return _match(relpath, self.set_iter_paths)

    def in_obs_zone(self, relpath: str) -> bool:
        return _match(relpath, self.obs_paths)

    def kind_exempted(self, relpath: str) -> bool:
        return _match(relpath, self.kind_exempt)


DEFAULT_POLICY = Policy()

"""Scheduler: the pump thread's time inside ``Server.step`` but outside the
backend's calls (generation rounds, admissions, retrieval sub-stages, host
stages), as a share of the window (a traced run's without the profiler's
own start and stop)."""


def read(ctx):
    step = ctx.span_total("step")
    inner = sum(ctx.span_total(n) for n in ("gen", "admit", "ret", "stage"))
    return 100.0 * max(step - inner, 0.0) / ctx.seconds if step else None

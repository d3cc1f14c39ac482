"""Thread-ownership markers for the serving runtime.

The wall-clock ingress work (ROADMAP item 1) puts ``Server.submit`` on a
real ingress thread while the wavefront loop keeps running on the scheduler
thread.  Today everything runs on one thread, so the markers below are pure
metadata — zero runtime behaviour — but they let ``repro_torch.analysis.lint``
machine-check the discipline *before* the threads arrive:

* ``@owned_by(domain, expose=(...))`` on a class declares which logical
  thread domain owns its mutable state.  ``expose`` names fields that other
  domains may *call through* (read-only projections such as ``metrics`` or
  the obs recorders); everything else is private to the owning domain.
* ``@handoff(*callers)`` on a method declares it a sanctioned cross-domain
  entry point: the listed caller domains (``"*"`` or no argument = any) may
  invoke it from their own threads.  Handoff methods are where locking /
  queue-crossing will land when the ingress thread becomes real.

The static checker (``repro/analysis/lint/ownership.py``) flags any write
or method call that crosses domains without going through a declared
handoff or exposed field.  Keeping the declarations *in the code* rather
than in the analyzer's config means the annotations travel with refactors
and show up in reviews.
"""
from __future__ import annotations

from typing import Callable, Iterable, Type, TypeVar

C = TypeVar("C")
F = TypeVar("F", bound=Callable)


def owned_by(domain: str, *, expose: Iterable[str] = ()) -> Callable[[Type[C]], Type[C]]:
    """Class decorator: all mutable state of the class belongs to ``domain``.

    ``expose`` lists attribute names that constitute the class's read-only
    surface — cross-domain code may call methods *through* them (e.g.
    ``server.sched.metrics.summary()``) without a handoff declaration.
    """
    domain_s = str(domain)
    expose_t = tuple(str(e) for e in expose)

    def mark(cls: Type[C]) -> Type[C]:
        cls.__owner_domain__ = domain_s
        cls.__owner_expose__ = expose_t
        return cls

    return mark


def handoff(*callers: str) -> Callable[[F], F]:
    """Method decorator: a declared cross-domain entry point.

    ``callers`` are the domains allowed to invoke the method from their own
    threads; no arguments (or ``"*"``) means any domain.  The decorator is
    a no-op at runtime — it exists for the static ownership checker and as
    the documented place where synchronisation will be added once the
    ingress thread is real.
    """
    caller_t = tuple(str(c) for c in callers) or ("*",)

    def mark(fn: F) -> F:
        fn.__handoff_callers__ = caller_t
        return fn

    return mark

"""repro-lint: AST-based invariant analyzer for the repro codebase.

Four checkers share one visitor framework (``framework.py``), a per-package
policy (``policy.py``), inline ``# repro-lint: disable=<rule>`` suppressions
and a JSON report artifact:

* ``determinism`` — unseeded RNG, wall-clock calls where only the virtual
  clock is allowed, and order-sensitive iteration over hash-ordered
  containers (``determinism/unseeded-rng``, ``determinism/wall-clock``,
  ``determinism/set-iteration``).
* ``registry`` — stage-kind string branching outside the stage registry
  (``registry/kind-branch``); the AST replacement for the old CI grep.
* ``hooks`` — obs/ recording paths stay record-only and every hook callsite
  in the scheduler is knob-guarded (``hooks/obs-mutation``,
  ``hooks/unguarded-hook``).
* ``ownership`` — ``@owned_by``/``@handoff`` thread-domain discipline
  (``ownership/cross-domain-write``, ``ownership/cross-domain-call``).

Run with ``python -m repro_torch.analysis.lint`` (see ``__main__.py``).
"""
from repro_torch.analysis.lint.framework import (  # noqa: F401
    Finding,
    LintReport,
    run_lint,
)
from repro_torch.analysis.lint.policy import DEFAULT_POLICY, Policy  # noqa: F401

ALL_RULES = (
    "determinism/unseeded-rng",
    "determinism/wall-clock",
    "determinism/set-iteration",
    "registry/kind-branch",
    "hooks/obs-mutation",
    "hooks/unguarded-hook",
    "ownership/cross-domain-write",
    "ownership/cross-domain-call",
)

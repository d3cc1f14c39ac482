"""Determinism checker: the golden-fingerprint invariant, statically.

Three rules:

* ``determinism/unseeded-rng`` — module-level ``random``/``np.random``
  calls draw from global or entropy-seeded state; every RNG in the repo
  must be an explicitly seeded generator.  Checked everywhere.
* ``determinism/wall-clock`` — ``time.time``/``perf_counter``/
  ``datetime.now`` and friends inside the virtual-clock zone
  (core/serving/crossreq/obs), where the event clock is the only legal
  time source.  RealBackend's measured-execution path is the sanctioned
  exception, carried as inline suppressions with justification.
* ``determinism/set-iteration`` — iterating a ``set``/``frozenset`` leaks
  hash order into whatever the loop does; inside the scheduling packages
  that is an ordering bug waiting for a string key.  Iterations wrapped in
  ``sorted()`` are fine, as are loops whose body only folds into other
  sets (order-insensitive).  ``dict`` views are insertion-ordered and only
  flagged when the loop body feeds an ordering-sensitive sink (heap push,
  dispatch selection, admission) — there the incidental insertion order
  becomes load-bearing schedule input.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.lint.framework import (
    FileContext,
    Finding,
    ScopedVisitor,
    attr_chain,
)

_DICT_VIEWS = ("values", "keys", "items")
# calls whose argument's iteration order is irrelevant (deterministic
# aggregate or explicit re-ordering)
_SANITIZERS = frozenset({
    "sorted", "len", "sum", "min", "max", "any", "all", "set", "frozenset",
})


def _is_set_expr(node: ast.expr, setvars: set, policy) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Name):
        return node.id in setvars
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        if isinstance(f, ast.Attribute) and f.attr in policy.set_returning_calls:
            return True
        return False
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)):
        return (_is_set_expr(node.left, setvars, policy)
                or _is_set_expr(node.right, setvars, policy))
    if isinstance(node, ast.IfExp):
        return (_is_set_expr(node.body, setvars, policy)
                or _is_set_expr(node.orelse, setvars, policy))
    if isinstance(node, ast.BoolOp):
        return any(_is_set_expr(v, setvars, policy) for v in node.values)
    return False


def _collect_set_vars(func: ast.AST, policy) -> set:
    """Flow-insensitive, source-order inference of set-typed local names."""
    setvars: set = set()
    for node in ast.walk(func):
        targets = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        elif isinstance(node, ast.NamedExpr):
            targets, value = [node.target], node.value
        else:
            continue
        if _is_set_expr(value, setvars, policy):
            for t in targets:
                if isinstance(t, ast.Name):
                    setvars.add(t.id)
    return setvars


def _is_dict_view(node: ast.expr) -> Optional[str]:
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _DICT_VIEWS and not node.args
            and not node.keywords):
        return node.func.attr
    return None


def _find_sink(body: list, policy) -> Optional[ast.Call]:
    for stmt in body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            name = None
            if isinstance(node.func, ast.Attribute):
                name = node.func.attr
            elif isinstance(node.func, ast.Name):
                name = node.func.id
            if name in policy.ordering_sinks:
                return node
    return None


def _order_insensitive_body(body: list, policy) -> bool:
    """True when every statement in the loop body only folds into sets
    (``x.add(...)``/``update``/``discard``), possibly behind guards —
    the one loop shape whose result cannot depend on iteration order."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.If):
            if not _order_insensitive_body(stmt.body, policy):
                return False
            if not _order_insensitive_body(stmt.orelse, policy):
                return False
            continue
        if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr in policy.order_insensitive_calls):
            continue
        return False
    return True


class _DetVisitor(ScopedVisitor):
    def __init__(self, ctx: FileContext, policy):
        super().__init__(ctx)
        self.policy = policy
        self.in_clock_zone = policy.in_virtual_clock_zone(ctx.relpath)
        self.in_set_zone = policy.in_set_iter_zone(ctx.relpath)
        self._setvar_stack: list[set] = [_collect_set_vars(ctx.tree, policy)]
        # comprehension/loop iterables already passed through a sanitizer
        self._sanitized: set = set()

    # -------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        policy = self.policy
        target = self.ctx.imports.resolve_call(node.func)
        if target is not None:
            if target in policy.global_rng_calls:
                self.emit(node, "determinism/unseeded-rng",
                          f"call to {target}() draws from global RNG state; "
                          "use an explicitly seeded np.random.default_rng / "
                          "SeedSequence")
            elif (target in policy.seed_required_calls
                  and not node.args and not node.keywords):
                self.emit(node, "determinism/unseeded-rng",
                          f"{target}() without a seed is entropy-seeded; "
                          "pass an explicit seed")
            elif self.in_clock_zone and target in policy.wallclock_calls:
                self.emit(node, "determinism/wall-clock",
                          f"wall-clock call {target}() in the virtual-clock "
                          "zone; scheduling code must use the event clock "
                          "(scheduler.now)")
        if (isinstance(node.func, ast.Name)
                and node.func.id in _SANITIZERS):
            for arg in node.args:
                self._sanitized.add(id(arg))
        self.generic_visit(node)

    # -------------------------------------------------------------- loops
    def _check_iteration(self, iter_node: ast.expr, body: list,
                         where: ast.AST, kind: str) -> None:
        if not self.in_set_zone or id(iter_node) in self._sanitized:
            return
        policy = self.policy
        setvars = self._setvar_stack[-1]
        if _is_set_expr(iter_node, setvars, policy):
            sink = _find_sink(body, policy) if body else None
            if sink is not None:
                name = (sink.func.attr if isinstance(sink.func, ast.Attribute)
                        else sink.func.id)  # type: ignore[union-attr]
                self.emit(where, "determinism/set-iteration",
                          f"{kind} over a set feeds ordering-sensitive "
                          f"sink {name}(); iterate sorted(...) instead")
            elif not (body and _order_insensitive_body(body, policy)):
                self.emit(where, "determinism/set-iteration",
                          f"{kind} over a set exposes hash order; wrap in "
                          "sorted(...) or fold order-insensitively")
        else:
            view = _is_dict_view(iter_node)
            if view is not None and body:
                sink = _find_sink(body, policy)
                if sink is not None:
                    name = (sink.func.attr
                            if isinstance(sink.func, ast.Attribute)
                            else sink.func.id)  # type: ignore[union-attr]
                    self.emit(
                        where, "determinism/set-iteration",
                        f"{kind} over dict.{view}() feeds ordering-"
                        f"sensitive sink {name}(); make the order explicit "
                        "(sorted or an ordered key list)")

    def visit_For(self, node: ast.For) -> None:
        self._check_iteration(node.iter, node.body, node, "iteration")
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            # a set comprehension re-folding a set stays order-insensitive
            if not isinstance(node, ast.SetComp):
                self._check_iteration(gen.iter, [], node, "comprehension")
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp
    visit_SetComp = _visit_comp

    # ------------------------------------------------------ function scope
    def _visit_func(self, node) -> None:
        self._setvar_stack.append(
            _collect_set_vars(node, self.policy)
            | self._setvar_stack[0])
        super()._visit_func(node)
        self._setvar_stack.pop()


class DeterminismChecker:
    name = "determinism"

    def __init__(self, policy):
        self.policy = policy

    def check(self, ctx: FileContext) -> list[Finding]:
        v = _DetVisitor(ctx, self.policy)
        v.visit(ctx.tree)
        return v.findings

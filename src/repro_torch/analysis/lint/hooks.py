"""Hook-passivity checker: observability must observe, never steer.

Two rules:

* ``hooks/obs-mutation`` — inside ``repro_torch/obs/``, a function must never
  write to or call a mutating method on an object that was *passed in*
  (the scheduler, dispatcher, jobs, requests...).  Recorder-owned state
  (anything rooted at ``self`` or built locally) is fair game.  Local
  aliases of parameters (``s = sched``; ``s.x = 1``) are tracked.
* ``hooks/unguarded-hook`` — in the scheduler file, every call through a
  hook attribute (``self.obs.…`` / ``self.telemetry.…``) must sit under a
  guard that mentions that attribute (``if self.obs is not None: …``), so
  the knobs-off path provably never touches the obs layer.

Both rules are syntactic over-approximations on purpose: obs code that
wants to do something clever can carry an inline suppression with a
justification, which is exactly the review surface we want.
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

MUTATION_RULE = "hooks/obs-mutation"
GUARD_RULE = "hooks/unguarded-hook"


def _chain_root(node: ast.expr) -> Optional[str]:
    """Base Name of an attribute/subscript chain, or None for anything
    passing through a call or other opaque expression."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _param_names(func) -> set:
    a = func.args
    names = [p.arg for p in
             (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return {n for n in names if n not in ("self", "cls")}


def _param_rooted_names(func, params: set) -> set:
    """params plus local names assigned from param-rooted chains."""
    rooted = set(params)
    for node in ast.walk(func):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.NamedExpr)):
            continue
        value = node.value
        if value is None:
            continue
        root = _chain_root(value) if isinstance(
            value, (ast.Name, ast.Attribute, ast.Subscript)) else None
        if root in rooted:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    rooted.add(t.id)
    return rooted


class _ObsVisitor(ScopedVisitor):
    """Passivity pass over one obs/ file."""

    def __init__(self, ctx: FileContext, policy):
        super().__init__(ctx)
        self.policy = policy
        self._rooted_stack: list[set] = [set()]

    def _visit_func(self, node) -> None:
        self._rooted_stack.append(
            _param_rooted_names(node, _param_names(node)))
        super()._visit_func(node)
        self._rooted_stack.pop()

    def _foreign(self, node: ast.expr) -> Optional[str]:
        root = _chain_root(node)
        if root is not None and root in self._rooted_stack[-1]:
            return root
        return None

    def _check_store(self, target: ast.expr, node: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._check_store(el, node)
            return
        if isinstance(target, ast.Starred):
            self._check_store(target.value, node)
            return
        if isinstance(target, (ast.Attribute, ast.Subscript)):
            root = self._foreign(target)
            if root is not None:
                self.emit(node, MUTATION_RULE,
                          f"obs hook writes to passed-in object {root!r}; "
                          "recording paths must be record-only")

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_store(t, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store(node.target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._check_store(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_store(t, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in self.policy.mutator_calls:
                root = self._foreign(node.func.value)
                if root is not None:
                    self.emit(
                        node, MUTATION_RULE,
                        f"obs hook calls mutator .{node.func.attr}() on "
                        f"passed-in object {root!r}; recording paths must "
                        "be record-only")
        self.generic_visit(node)


def _mentions_hook_attr(test: ast.expr, attr: str) -> bool:
    for node in ast.walk(test):
        if (isinstance(node, ast.Attribute) and node.attr == attr
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return True
    return False


class _GuardWalker:
    """Recursive walker carrying the active guard tests, including
    short-circuit BoolOp prefixes (``self.obs and self.obs.f()``)."""

    def __init__(self, ctx: FileContext, policy):
        self.ctx = ctx
        self.policy = policy
        self.findings: list[Finding] = []

    def walk(self, node: ast.AST, guards: tuple) -> None:
        if isinstance(node, ast.If) or isinstance(node, ast.IfExp):
            self.walk(node.test, guards)
            body = node.body if isinstance(node.body, list) else [node.body]
            orelse = (node.orelse if isinstance(node.orelse, list)
                      else [node.orelse])
            for child in body:
                self.walk(child, guards + (node.test,))
            for child in orelse:
                self.walk(child, guards)
            return
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            seen: tuple = guards
            for value in node.values:
                self.walk(value, seen)
                seen = seen + (value,)
            return
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if (chain is not None and len(chain) >= 3
                    and chain[0] == "self"
                    and chain[1] in self.policy.hook_attrs):
                attr = chain[1]
                if not any(_mentions_hook_attr(g, attr) for g in guards):
                    self.findings.append(Finding(
                        path=self.ctx.relpath, line=node.lineno,
                        col=node.col_offset, rule=GUARD_RULE,
                        message=(
                            f"hook call self.{attr}."
                            f"{'.'.join(chain[2:])}() is not guarded by "
                            f"'if self.{attr} is not None'; the knobs-off "
                            "path must never touch the obs layer")))
        for child in ast.iter_child_nodes(node):
            self.walk(child, guards)


class HooksChecker:
    name = "hooks"

    def __init__(self, policy):
        self.policy = policy

    def check(self, ctx: FileContext) -> list[Finding]:
        findings: list[Finding] = []
        if self.policy.in_obs_zone(ctx.relpath):
            v = _ObsVisitor(ctx, self.policy)
            v.visit(ctx.tree)
            findings.extend(v.findings)
        if ctx.relpath == self.policy.hook_file:
            w = _GuardWalker(ctx, self.policy)
            w.walk(ctx.tree, ())
            findings.extend(w.findings)
        return findings

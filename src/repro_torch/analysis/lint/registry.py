"""Registry-discipline checker: stage-kind strings stay in the registry.

The stage registry (``repro_torch/core/stages.py``) owns all per-kind behaviour;
scheduler/serving/crossreq layers must dispatch through ``stages.spec(...)``
and never branch on node-kind strings.  The old CI grep only caught the
literal pattern ``kind == "..."``; this AST checker also catches

* membership tests — ``if n.kind in ("retrieval", "rerank")``,
* aliased locals — ``k = node.kind`` ... ``if k == "generation"``,
* yoda comparisons — ``"retrieval" == st.kind``,
* ``match`` statements whose subject is a kind and whose cases pattern-
  match kind string literals.

``core/stages.py`` (the registry) and ``core/ragraph.py`` (the node
dataclass definitions with their class-level kind tags) are exempt.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint.framework import (
    FileContext,
    Finding,
    ScopedVisitor,
    attr_chain,
)

RULE = "registry/kind-branch"


def _collect_kind_aliases(tree: ast.AST) -> set:
    """Names assigned from a ``.kind`` attribute anywhere in the scope."""
    aliases: set = set()

    def kindish(expr: ast.expr) -> bool:
        return ((isinstance(expr, ast.Attribute) and expr.attr == "kind")
                or (isinstance(expr, ast.Name) and expr.id in aliases))

    for node in ast.walk(tree):
        targets, value = [], None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        elif isinstance(node, ast.NamedExpr):
            targets, value = [node.target], node.value
        if value is not None and kindish(value):
            for t in targets:
                if isinstance(t, ast.Name):
                    aliases.add(t.id)
    return aliases


class _RegistryVisitor(ScopedVisitor):
    def __init__(self, ctx: FileContext, policy):
        super().__init__(ctx)
        self.policy = policy
        self.aliases = _collect_kind_aliases(ctx.tree)

    def _kindish(self, expr: ast.expr) -> bool:
        if isinstance(expr, ast.Attribute) and expr.attr == "kind":
            return True
        return isinstance(expr, ast.Name) and expr.id in self.aliases

    def _kind_literals(self, expr: ast.expr) -> list:
        """Stage-kind string constants inside a literal or container."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return ([expr.value]
                    if expr.value in self.policy.stage_kinds else [])
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out = []
            for e in expr.elts:
                out.extend(self._kind_literals(e))
            return out
        return []

    def visit_Compare(self, node: ast.Compare) -> None:
        sides = [node.left] + list(node.comparators)
        for op, lhs, rhs in zip(node.ops, sides, sides[1:]):
            if not isinstance(op, (ast.Eq, ast.NotEq, ast.In, ast.NotIn)):
                continue
            for kind_side, lit_side in ((lhs, rhs), (rhs, lhs)):
                lits = self._kind_literals(lit_side)
                if lits and self._kindish(kind_side):
                    self.emit(
                        node, RULE,
                        f"stage-kind comparison against {lits!r} outside "
                        "the registry; dispatch through "
                        "repro_torch.core.stages.spec(kind) instead")
                    break
        self.generic_visit(node)

    def visit_Match(self, node: ast.Match) -> None:
        if self._kindish(node.subject):
            for case in node.cases:
                lits = [
                    p.value.value
                    for p in ast.walk(case.pattern)
                    if isinstance(p, ast.MatchValue)
                    and isinstance(p.value, ast.Constant)
                    and isinstance(p.value.value, str)
                    and p.value.value in self.policy.stage_kinds
                ]
                if lits:
                    self.emit(
                        case.pattern, RULE,
                        f"match on stage kind {lits!r} outside the "
                        "registry; dispatch through "
                        "repro_torch.core.stages.spec(kind) instead")
        self.generic_visit(node)


class RegistryChecker:
    name = "registry"

    def __init__(self, policy):
        self.policy = policy

    def check(self, ctx: FileContext) -> list[Finding]:
        if self.policy.kind_exempted(ctx.relpath):
            return []
        v = _RegistryVisitor(ctx, self.policy)
        v.visit(ctx.tree)
        return v.findings

"""Thread-ownership checker: static groundwork for the ingress thread.

Classes annotated ``@owned_by(domain, expose=(...))`` (see
``repro_torch/core/ownership.py``) declare which logical thread domain owns
their mutable state; methods annotated ``@handoff(*callers)`` are the
sanctioned cross-domain entry points.  The checker runs in two phases:

1. **collect** (all files): domain declarations, handoff methods, exposed
   fields, and handle inference — ``self.sched = WavefrontScheduler(...)``
   inside an owned class records that its ``sched`` field holds a
   scheduler-domain object.
2. **check** (per file): inside a method of a class owned by domain A, an
   access through a cross-domain handle (a field inferred to hold a
   domain-B object, B != A) is flagged when it is

   * a *write* past the handle (``self.sched.now = 5``,
     ``self.sched.active.append(r)`` via a mutator name), rule
     ``ownership/cross-domain-write``; rebinding the handle itself
     (``self.sched = ...``) is ownership of the *reference* and stays
     legal, or
   * a *method call* that is neither a declared ``@handoff`` for domain A
     nor routed through an ``expose``-listed read surface, rule
     ``ownership/cross-domain-call``.

   Plain attribute reads are allowed (single-writer snapshots); local
   aliases of cross-domain handles (``tel = self.sched.telemetry``) are
   followed.

This is deliberately lightweight: it reasons only about ``self``-rooted
chains inside annotated classes, so unannotated glue code (launch
scripts, tests) incurs no obligations.  The point is that when the
wall-clock ingress thread lands, every scheduler-state touch from the
server side is already enumerated — each ``@handoff`` is a place to put a
lock or queue crossing.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from repro_torch.analysis.lint.framework import (
    FileContext,
    Finding,
    ScopedVisitor,
    attr_chain,
)

WRITE_RULE = "ownership/cross-domain-write"
CALL_RULE = "ownership/cross-domain-call"


def _decorator_call(dec: ast.expr, name: str) -> Optional[ast.Call]:
    if isinstance(dec, ast.Call):
        f = dec.func
        if (isinstance(f, ast.Name) and f.id == name) or (
                isinstance(f, ast.Attribute) and f.attr == name):
            return dec
    return None


def _str_args(call: ast.Call) -> list:
    return [a.value for a in call.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)]


@dataclasses.dataclass
class OwnedClass:
    name: str
    domain: str
    expose: tuple = ()
    handoffs: dict = dataclasses.field(default_factory=dict)  # method -> callers


class OwnershipChecker:
    name = "ownership"

    def __init__(self, policy):
        self.policy = policy
        self.classes: dict[str, OwnedClass] = {}
        # (owner class name, attr) -> handle's target class name
        self.handles: dict[tuple, str] = {}

    # ------------------------------------------------------------- phase 1
    def collect(self, ctx: FileContext) -> None:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            owned = None
            for dec in node.decorator_list:
                call = _decorator_call(dec, "owned_by")
                if call is None:
                    continue
                domains = _str_args(call)
                expose: tuple = ()
                for kw in call.keywords:
                    if kw.arg == "expose" and isinstance(
                            kw.value, (ast.Tuple, ast.List)):
                        expose = tuple(
                            e.value for e in kw.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str))
                if domains:
                    owned = OwnedClass(node.name, domains[0], expose)
            if owned is None:
                continue
            self.classes[node.name] = owned
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for dec in item.decorator_list:
                    call = _decorator_call(dec, "handoff")
                    if call is not None:
                        callers = tuple(_str_args(call)) or ("*",)
                        owned.handoffs[item.name] = callers
            # handle inference: self.<attr> = SomeOwnedClass(...)
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                value = sub.value
                if not isinstance(value, ast.Call):
                    continue
                cname = None
                if isinstance(value.func, ast.Name):
                    cname = value.func.id
                elif isinstance(value.func, ast.Attribute):
                    cname = value.func.attr
                if cname is None:
                    continue
                for t in sub.targets:
                    chain = attr_chain(t) if isinstance(
                        t, ast.Attribute) else None
                    if chain and len(chain) == 2 and chain[0] == "self":
                        self.handles[(node.name, chain[1])] = cname

    # ------------------------------------------------------------- phase 2
    def check(self, ctx: FileContext) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and node.name in self.classes:
                v = _OwnershipVisitor(ctx, self.policy, self, node)
                v.visit(node)
                findings.extend(v.findings)
        return findings

    def handle_target(self, owner_cls: str, attr: str) -> Optional[OwnedClass]:
        cname = self.handles.get((owner_cls, attr))
        if cname is None:
            return None
        return self.classes.get(cname)


class _OwnershipVisitor(ScopedVisitor):
    def __init__(self, ctx: FileContext, policy, checker: OwnershipChecker,
                 cls: ast.ClassDef):
        super().__init__(ctx)
        self.policy = policy
        self.checker = checker
        self.cls = cls
        self.owned = checker.classes[cls.name]
        # local alias name -> (handle attr, subchain after the handle)
        self._alias_stack: list[dict] = [{}]

    # ----------------------------------------------------------- resolution
    def _cross_handle(self, attr: str) -> Optional[OwnedClass]:
        target = self.checker.handle_target(self.cls.name, attr)
        if target is not None and target.domain != self.owned.domain:
            return target
        return None

    def _resolve(self, node: ast.expr) -> Optional[tuple]:
        """Resolve an expression to (target OwnedClass, subchain) when it is
        rooted at a cross-domain handle, following local aliases."""
        chain = attr_chain(node)
        if chain is None:
            return None
        if chain[0] == "self" and len(chain) >= 2:
            target = self._cross_handle(chain[1])
            if target is not None:
                return target, chain[2:]
            return None
        alias = self._alias_stack[-1].get(chain[0])
        if alias is not None:
            attr, sub = alias
            target = self._cross_handle(attr)
            if target is not None:
                return target, list(sub) + chain[1:]
        return None

    def _visit_func(self, node) -> None:
        aliases: dict = dict(self._alias_stack[-1])
        for sub in ast.walk(node):
            if not isinstance(sub, (ast.Assign, ast.NamedExpr)):
                continue
            value = sub.value
            chain = attr_chain(value) if isinstance(
                value, ast.Attribute) else None
            if chain and chain[0] == "self" and len(chain) >= 2:
                if self._cross_handle(chain[1]) is not None:
                    targets = (sub.targets if isinstance(sub, ast.Assign)
                               else [sub.target])
                    for t in targets:
                        if isinstance(t, ast.Name):
                            aliases[t.id] = (chain[1], chain[2:])
        self._alias_stack.append(aliases)
        super()._visit_func(node)
        self._alias_stack.pop()

    # --------------------------------------------------------------- writes
    def _check_store(self, target: ast.expr, node: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._check_store(el, node)
            return
        if isinstance(target, ast.Starred):
            target = target.value
        if isinstance(target, ast.Name):
            # rebinding a local (even one aliasing a cross-domain handle)
            # only changes the local namespace, never foreign state
            return
        base = target
        depth_past_handle = isinstance(base, ast.Subscript)
        while isinstance(base, ast.Subscript):
            base = base.value
            if isinstance(base, ast.Subscript):
                continue
        if not isinstance(base, (ast.Attribute, ast.Name)):
            return
        resolved = self._resolve(base)
        if resolved is None:
            return
        target_cls, sub = resolved
        # rebinding the handle itself (subchain empty, no subscript) is the
        # owner managing its own reference, not a foreign-state write
        if not sub and not depth_past_handle:
            return
        self.emit(node, WRITE_RULE,
                  f"{self.owned.domain!r}-domain code writes "
                  f"{target_cls.domain!r}-owned state "
                  f"({target_cls.name}.{'.'.join(sub) or '[...]'}); route "
                  "the mutation through a declared @handoff method")

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

    # ---------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        resolved = (self._resolve(node.func)
                    if isinstance(node.func, ast.Attribute) else None)
        if resolved is not None:
            target_cls, sub = resolved
            if sub:
                ok = False
                if len(sub) == 1:
                    callers = target_cls.handoffs.get(sub[0])
                    ok = callers is not None and (
                        "*" in callers or self.owned.domain in callers)
                else:
                    ok = sub[0] in target_cls.expose
                if not ok:
                    self.emit(
                        node, CALL_RULE,
                        f"{self.owned.domain!r}-domain call to "
                        f"{target_cls.name}.{'.'.join(sub)}() is not a "
                        "declared @handoff and not routed through an "
                        "exposed read surface")
        self.generic_visit(node)

"""Shared visitor framework for repro-lint checkers.

One parse per file; every checker gets a :class:`FileContext` (AST, source
lines, import-alias table, inline suppressions) and returns
:class:`Finding` rows.  The engine (:func:`run_lint`) applies suppressions,
canonicalises ordering (findings sort by path/line/col/rule, never by scan
order) and renders text or a JSON report — the report is a pure function
of the file *contents*, so shuffling the input file list cannot change a
byte of it.

Suppression syntax, modelled on pylint::

    time.time()  # repro-lint: disable=wall-clock -- justification here

A suppression comment on its own line applies to the next code line; rule
names may be the short form (``wall-clock``) or fully qualified
(``determinism/wall-clock``), comma-separated.  Suppressions require a
rule name — there is deliberately no ``disable=all``.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Iterable, Optional

REPORT_SCHEMA_VERSION = 1

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9_/,\-]+)")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation, addressed by file-relative position."""

    path: str  # posix path relative to the scan root, e.g. repro_torch/core/x.py
    line: int
    col: int
    rule: str  # qualified, e.g. "determinism/wall-clock"
    message: str

    @property
    def short_rule(self) -> str:
        return self.rule.rsplit("/", 1)[-1]

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class Suppressions:
    """Per-file map of line -> suppressed short rule names."""

    def __init__(self, source: str):
        self.by_line: dict[int, set[str]] = {}
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(source).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return
        code_lines = {
            t.start[0]
            for t in tokens
            if t.type not in (tokenize.COMMENT, tokenize.NL,
                              tokenize.NEWLINE, tokenize.INDENT,
                              tokenize.DEDENT, tokenize.ENDMARKER)
        }
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip().rsplit("/", 1)[-1]
                     for r in m.group(1).split(",") if r.strip()}
            row = tok.start[0]
            # a comment-only line suppresses the next code line
            target = row if row in code_lines else row + 1
            self.by_line.setdefault(target, set()).update(rules)

    def covers(self, finding: Finding) -> bool:
        return finding.short_rule in self.by_line.get(finding.line, ())


class ImportTable:
    """Maps local names to canonical dotted module paths.

    ``import numpy as np`` -> ``np: numpy``;
    ``from time import perf_counter`` -> ``perf_counter: time.perf_counter``.
    """

    def __init__(self, tree: ast.AST):
        self.names: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.names[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.names[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}")

    def resolve_call(self, func: ast.expr) -> Optional[str]:
        """Canonical dotted path of a call target, or None.

        ``np.random.rand`` -> ``numpy.random.rand`` given ``import numpy
        as np``; a bare ``perf_counter`` resolves through a from-import.
        """
        parts: list[str] = []
        node = func
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.names.get(node.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))


@dataclasses.dataclass
class FileContext:
    path: str  # absolute filesystem path
    relpath: str  # posix path relative to scan root
    source: str
    tree: ast.Module
    imports: ImportTable
    suppressions: Suppressions

    @classmethod
    def load(cls, path: str, relpath: str) -> "FileContext":
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
        return cls(path=path, relpath=relpath, source=source, tree=tree,
                   imports=ImportTable(tree),
                   suppressions=Suppressions(source))


def attr_chain(node: ast.expr) -> Optional[list[str]]:
    """``self.sched.metrics`` -> ["self", "sched", "metrics"]; None when the
    expression is not a plain name/attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return list(reversed(parts))


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing class/function stack — the one
    shared chassis every checker builds on."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.findings: list[Finding] = []
        self.class_stack: list[ast.ClassDef] = []
        self.func_stack: list[ast.AST] = []

    # ----------------------------------------------------------- plumbing
    def emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(
            path=self.ctx.relpath, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0), rule=rule, message=message))

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node) -> None:
        self.func_stack.append(node)
        self.generic_visit(node)
        self.func_stack.pop()

    def visit_FunctionDef(self, node) -> None:
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._visit_func(node)

    @property
    def current_class(self) -> Optional[ast.ClassDef]:
        return self.class_stack[-1] if self.class_stack else None

    @property
    def current_func(self):
        return self.func_stack[-1] if self.func_stack else None


@dataclasses.dataclass
class LintReport:
    root: str
    files: list[str]
    findings: list[Finding]
    suppressed: list[Finding]
    rules: tuple

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        by_rule: dict[str, int] = {r: 0 for r in self.rules}
        for f in self.findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "schema_version": REPORT_SCHEMA_VERSION,
            "tool": "repro-lint",
            "rules": list(self.rules),
            "files_scanned": len(self.files),
            "files": list(self.files),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "summary": {
                "total": len(self.findings),
                "suppressed": len(self.suppressed),
                "by_rule": {k: by_rule[k] for k in sorted(by_rule)},
            },
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True) + "\n"

    def render_text(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"repro-lint: {len(self.findings)} finding(s), "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.files)} file(s) scanned")
        return "\n".join(lines)


def iter_py_files(paths: Iterable[str]) -> list[str]:
    out: set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.add(os.path.abspath(p))
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for fn in filenames:
                    if fn.endswith(".py"):
                        out.add(os.path.abspath(os.path.join(dirpath, fn)))
    return sorted(out)


def run_lint(paths: Iterable[str], root: str, policy=None,
             baseline: Optional[Iterable[dict]] = None) -> LintReport:
    """Run every checker over ``paths`` (files or directories).

    ``root`` anchors the policy's package-relative path matching: a file at
    ``<root>/repro_torch/core/wavefront.py`` is matched against policy prefixes
    like ``repro_torch/core/``.  ``baseline`` (optional) is a list of finding
    dicts to subtract — a migration crutch the repo itself does not use
    (its baseline is empty).
    """
    # resolved late so checkers can import the framework without a cycle
    from repro_torch.analysis.lint import ALL_RULES
    from repro_torch.analysis.lint.determinism import DeterminismChecker
    from repro_torch.analysis.lint.hooks import HooksChecker
    from repro_torch.analysis.lint.ownership import OwnershipChecker
    from repro_torch.analysis.lint.registry import RegistryChecker
    from repro_torch.analysis.lint.policy import DEFAULT_POLICY

    policy = policy or DEFAULT_POLICY
    root = os.path.abspath(root)
    files = iter_py_files(paths)
    contexts: list[FileContext] = []
    findings: list[Finding] = []
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            contexts.append(FileContext.load(path, rel))
        except SyntaxError as e:
            findings.append(Finding(
                path=rel, line=e.lineno or 0, col=e.offset or 0,
                rule="parse/error", message=f"cannot parse: {e.msg}"))
    # ownership needs a cross-file declaration pass; order the contexts by
    # relpath so every phase is independent of filesystem enumeration order
    contexts.sort(key=lambda c: c.relpath)
    checkers = [DeterminismChecker(policy), RegistryChecker(policy),
                HooksChecker(policy), OwnershipChecker(policy)]
    for checker in checkers:
        collect = getattr(checker, "collect", None)
        if collect is not None:
            for ctx in contexts:
                collect(ctx)
    for ctx in contexts:
        for checker in checkers:
            findings.extend(checker.check(ctx))
    kept: list[Finding] = []
    suppressed: list[Finding] = []
    by_rel = {c.relpath: c for c in contexts}
    base_keys = {(b["path"], b["rule"], b.get("line"))
                 for b in (baseline or ())}
    for f in findings:
        ctx = by_rel.get(f.path)
        if ctx is not None and ctx.suppressions.covers(f):
            suppressed.append(f)
        elif ((f.path, f.rule, f.line) in base_keys
              or (f.path, f.rule, None) in base_keys):
            suppressed.append(f)
        else:
            kept.append(f)
    return LintReport(
        root=root,
        files=sorted(c.relpath for c in contexts),
        findings=sorted(kept),
        suppressed=sorted(suppressed),
        rules=ALL_RULES,
    )

"""CLI for repro-lint::

    PYTHONPATH=src python -m repro_torch.analysis.lint                 # scan repro_torch/
    PYTHONPATH=src python -m repro_torch.analysis.lint --format json   # JSON to stdout
    PYTHONPATH=src python -m repro_torch.analysis.lint --report out.json path/...

Exit codes: 0 clean, 1 findings, 2 bad invocation.  With no paths the
scan target is the installed ``repro`` package itself and the scan root is
its parent directory (``src/`` in a checkout), so policy prefixes like
``repro_torch/core/`` resolve identically however the tool is launched.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import repro_torch
from repro_torch.analysis.lint import ALL_RULES, run_lint


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST invariant analyzer: determinism, registry "
                    "discipline, hook passivity, thread ownership.")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to scan "
                             "(default: the repro package)")
    parser.add_argument("--root", default=None,
                        help="scan root for package-relative policy paths "
                             "(default: parent of the repro package)")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="stdout format (default text)")
    parser.add_argument("--report", default=None, metavar="FILE",
                        help="also write the JSON report to FILE")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="JSON file of known findings to subtract "
                             "(the repo's own baseline is empty)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule ids and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(rule)
        return 0

    # repro is a namespace package (no __init__.py): locate it via __path__
    pkg_dir = os.path.abspath(list(repro_torch.__path__)[0])
    paths = args.paths or [pkg_dir]
    root = args.root or os.path.dirname(pkg_dir)
    baseline = None
    if args.baseline:
        try:
            with open(args.baseline, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            print(f"repro-lint: cannot read baseline: {e}", file=sys.stderr)
            return 2
        baseline = data.get("findings", data) if isinstance(data, dict) else data

    report = run_lint(paths, root=root, baseline=baseline)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(report.to_json())
    if args.format == "json":
        sys.stdout.write(report.to_json())
    else:
        print(report.render_text())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())

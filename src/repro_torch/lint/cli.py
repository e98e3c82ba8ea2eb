"""CLI: ``python -m repro_torch.lint [paths] [--format gh|json]
[--list-hot] [--baseline ...]``.

Port of `repro/lint/cli.py`. Exit codes: 0 clean (no unsuppressed
errors), 1 findings, 2 usage error (bad arguments, a baseline entry:
the port's baseline scope is empty).

Suppressions: ``# lint: disable=RULE[,RULE...] — reason`` on the
finding's line or in the comment block right above it. The reason is
mandatory: a suppression without one is itself a finding (SUP001).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.lint import baseline as _baseline
from repro_torch.lint.findings import Finding, Severity
from repro_torch.lint.resolver import HotResolver, ModuleInfo, scan_paths
from repro_torch.lint.rules import run_rules

# `# lint: disable=HS001,OB001 — the flush's result goes to the host`
_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Z0-9,\s]+?)"
    r"(?:\s*(?:—|--|-)\s*(.*?))?\s*$")


class Suppression:
    __slots__ = ("rules", "reason", "line", "used")

    def __init__(self, rules: Set[str], reason: Optional[str], line: int):
        self.rules = rules
        self.reason = reason
        self.line = line
        self.used = False


def collect_suppressions(mod: ModuleInfo) -> List[Suppression]:
    out: List[Suppression] = []
    for i, text in enumerate(mod.lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = (m.group(2) or "").strip() or None
        out.append(Suppression(rules, reason, i))
    return out


def _covers(s: Suppression, line: int, lines: List[str]) -> bool:
    """A suppression covers the finding's line, or sits in a contiguous
    comment block immediately above it (multi-line reasons)."""
    if s.line == line:
        return True
    if not s.line < line:
        return False
    for i in range(s.line, line - 1):  # 0-indexed lines between
        t = lines[i].strip() if i < len(lines) else ""
        if t and not t.startswith("#"):
            return False
    return True


def apply_suppressions(
        findings: Sequence[Finding],
        sup_by_path: Dict[str, List[Suppression]],
        lines_by_path: Optional[Dict[str, List[str]]] = None,
        ) -> List[Finding]:
    """Drop suppressed findings; a reason-less suppression is SUP001."""
    lines_by_path = lines_by_path or {}
    kept: List[Finding] = []
    for f in findings:
        lines = lines_by_path.get(f.path, [])
        hit = next((s for s in sup_by_path.get(f.path, [])
                    if f.rule in s.rules and _covers(s, f.line, lines)),
                   None)
        if hit is None:
            kept.append(f)
        else:
            hit.used = True
    for path, sups in sorted(sup_by_path.items()):
        for s in sups:
            if s.reason is None:
                kept.append(Finding(
                    rule="SUP001", severity=Severity.ERROR, path=path,
                    line=s.line, col=1,
                    message=f"suppression of {','.join(sorted(s.rules))} "
                            f"has no reason — use `# lint: "
                            f"disable=RULE — reason`"))
    return sorted(kept, key=lambda f: (f.path, f.line, f.rule))


class LintResult:
    """What one lint run saw: the surviving findings, the resolver, and
    the suppressions that silenced a finding (with their reasons)."""

    def __init__(self, findings, resolver, suppressions):
        self.findings: List[Finding] = findings
        self.resolver: HotResolver = resolver
        self.suppressions: List[Tuple[str, Suppression]] = suppressions


def lint(paths: Sequence[str],
         baseline_path: Optional[str] = None) -> LintResult:
    """Scan, resolve, run all rules, apply suppressions and a baseline.
    Raises ValueError on a baseline entry (the port's scope is empty)."""
    modules = scan_paths(paths)
    resolver = HotResolver(modules)
    findings = run_rules(modules, resolver)
    sup_by_path = {m.path: collect_suppressions(m) for m in modules}
    lines_by_path = {m.path: m.lines for m in modules}
    findings = apply_suppressions(findings, sup_by_path, lines_by_path)
    if baseline_path is not None:
        bl = _baseline.load_baseline(baseline_path)
        bad = _baseline.check_scope(bl)
        if bad:
            raise ValueError(
                "baseline entries outside the (empty) baseline scope: "
                f"repro_torch is held to zero findings: {bad}")
        findings = _baseline.apply_baseline(findings, bl)
    used = [(p, s) for p, sups in sorted(sup_by_path.items())
            for s in sups if s.used]
    return LintResult(findings, resolver, used)


def _emit(findings: Sequence[Finding], fmt: str, out) -> None:
    if fmt == "json":
        json.dump({"findings": [f.to_dict() for f in findings],
                   "errors": sum(1 for f in findings
                                 if f.severity == Severity.ERROR),
                   "warnings": sum(1 for f in findings
                                   if f.severity == Severity.WARNING)},
                  out, indent=2)
        out.write("\n")
        return
    for f in findings:
        out.write((f.format_gh() if fmt == "gh" else f.format_text())
                  + "\n")
    if fmt == "text":
        errs = sum(1 for f in findings if f.severity == Severity.ERROR)
        out.write(f"{len(findings)} finding(s), {errs} error(s)\n")


def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="host-sync & device-residency linter for repro_torch")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to scan "
                         "(default: src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (the port's scope is empty: any "
                         "entry is a usage error)")
    ap.add_argument("--format", choices=("text", "gh", "json"),
                    default="text")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write current findings as a baseline and exit")
    ap.add_argument("--list-hot", action="store_true",
                    help="print the resolved hot-function set")
    ap.add_argument("--summary", action="store_true",
                    help="print hot functions, findings and reasoned "
                         "suppressions as one JSON line")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0
    try:
        res = lint(args.paths or ["src/repro_torch"], args.baseline)
    except (ValueError, OSError) as e:
        print(f"repro_torch.lint: {e}", file=sys.stderr)
        return 2
    findings = res.findings
    if args.list_hot:
        for fn in sorted(res.resolver.hot_functions(),
                         key=lambda f: (f.path, f.line)):
            out.write(f"{fn.path}:{fn.line}: {fn.qualname}"
                      f"  [{fn.trace_via}]\n")
        return 0
    if args.write_baseline:
        bad = [f for f in findings if not _baseline.in_scope(f.path)]
        if bad:
            print("repro_torch.lint: refusing to baseline findings "
                  "outside the (empty) baseline scope:", file=sys.stderr)
            for f in bad:
                print(f"  {f.format_text()}", file=sys.stderr)
            return 2
        _baseline.write_baseline(args.write_baseline, findings)
        out.write(f"wrote {args.write_baseline} "
                  f"({len(findings)} finding(s))\n")
        return 0
    if args.summary:
        by_rule: Dict[str, int] = {}
        for _p, s in res.suppressions:
            for r in s.rules:
                by_rule[r] = by_rule.get(r, 0) + 1
        out.write(json.dumps({
            "hot_functions": len(res.resolver.hot_functions()),
            "findings": len(findings),
            "errors": sum(1 for f in findings
                          if f.severity == Severity.ERROR),
            "suppressions": len(res.suppressions),
            "suppressions_by_rule": dict(sorted(by_rule.items()))}) + "\n")
    else:
        _emit(findings, args.format, out)
    errors = [f for f in findings if f.severity == Severity.ERROR]
    return 1 if errors else 0

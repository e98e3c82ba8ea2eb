"""Count-based baseline, in the format of `repro/lint/baseline.py`.

The reference grandfathers its legacy LM-skeleton modules through a
committed baseline. The port has no legacy modules: `BASELINE_SCOPE` is
empty, so every baselined path is a usage error (exit 2) and the whole
of `repro_torch` is held to zero findings. The functions stay so a
baseline file round-trips in the reference's format
(``{"<relpath>": {"<rule>": count}}``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

from repro_torch.lint.findings import Finding

#: Path prefixes (relative, `/`-normalized) the baseline may cover: none.
BASELINE_SCOPE: Tuple[str, ...] = ()

BaselineMap = Dict[str, Dict[str, int]]


def _norm(path: str) -> str:
    return path.replace("\\", "/").lstrip("./")


def in_scope(path: str) -> bool:
    p = _norm(path)
    return any(p.startswith(pref) for pref in BASELINE_SCOPE)


def load_baseline(path: str) -> BaselineMap:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: baseline must be a JSON object")
    out: BaselineMap = {}
    for rel, rules in data.items():
        if not isinstance(rules, dict):
            raise ValueError(f"{path}: entry for {rel!r} must map "
                             f"rule -> count")
        out[_norm(rel)] = {str(r): int(c) for r, c in rules.items()}
    return out


def check_scope(baseline: BaselineMap) -> List[str]:
    """Baselined paths outside BASELINE_SCOPE (each is a usage error)."""
    return [rel for rel in sorted(baseline) if not in_scope(rel)]


def build_baseline(findings: Sequence[Finding]) -> BaselineMap:
    out: BaselineMap = {}
    for f in findings:
        rel = _norm(f.path)
        out.setdefault(rel, {})
        out[rel][f.rule] = out[rel].get(f.rule, 0) + 1
    return {rel: dict(sorted(rules.items()))
            for rel, rules in sorted(out.items())}


def write_baseline(path: str, findings: Sequence[Finding]) -> BaselineMap:
    bl = build_baseline(findings)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(bl, f, indent=2, sort_keys=True)
        f.write("\n")
    return bl


def apply_baseline(findings: Sequence[Finding],
                   baseline: BaselineMap) -> List[Finding]:
    """Drop findings covered by the baseline (count-based per
    (path, rule)); anything beyond the baselined count surfaces."""
    budget: Dict[Tuple[str, str], int] = {}
    for rel, rules in baseline.items():
        for rule, count in rules.items():
            budget[(rel, rule)] = count
    out: List[Finding] = []
    for f in findings:
        k = (_norm(f.path), f.rule)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            out.append(f)
    return out

"""Finding record shared by the resolver, rules, baseline and CLI.

Port of `repro/lint/findings.py`: the same fields and the same
``path:line:col: severity[RULE] message`` text, so the two linters'
reports read alike.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


class Severity:
    ERROR = "error"
    WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``path`` is relative to the lint invocation's working directory (run
    from the repo root, so baselines are repo-relative). ``context``
    carries the resolver's evidence: for hot-function rules, the chain
    that makes the enclosing function hot (e.g. ``hot via called from
    .../engine.py::Simulation.step:412``).
    """
    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    context: Optional[str] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("context") is None:
            del d["context"]
        return d

    def format_text(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        out = f"{loc}: {self.severity}[{self.rule}] {self.message}"
        if self.context:
            out += f"\n    {self.context}"
        return out

    def format_gh(self) -> str:
        kind = "error" if self.severity == Severity.ERROR else "warning"
        msg = self.message if not self.context else (
            f"{self.message} ({self.context})")
        return (f"::{kind} file={self.path},line={self.line},"
                f"col={self.col},title={self.rule}::{msg}")

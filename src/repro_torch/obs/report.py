"""BenchReport: the uniform schema a benchmark of the port emits.

Port of `repro/obs/report.py`, the same schema string, keys and error
text, so one reader takes the reports of both packages. The contract:

.. code-block:: json

    {
      "schema":   "repro.bench/1",
      "bench":    "md_step",
      "config":   { ... knobs the run was invoked with ... },
      "metrics":  { ... bench-specific results, any nesting ... },
      "phases":   { "advance": 12.3, "finish": 40.1 },   // ms
      "counters": { "compiles": 3, "retraces": 0 }
    }

``phases`` is the uniform per-phase wall-time breakdown (milliseconds,
flat); ``counters`` holds integer event counts (usually from
``repro_torch.obs.events``). Rich bench-specific
detail stays under ``metrics`` — the schema constrains the envelope,
not the payload.

:func:`validate_report` is the shared checker every ``--check`` path
runs before gating, so schema drift fails CI instead of accumulating.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Mapping, Optional

__all__ = ["SCHEMA", "bench_report", "validate_report", "write_report",
           "phase_coverage", "json_safe"]

SCHEMA = "repro.bench/1"


def json_safe(obj: Any) -> Any:
    """Recursively replace non-finite floats with None (JSON-legal).
    numpy scalars and 0-dim tensors become Python numbers (``.item()``);
    an array or a tensor of more than one element is left as it is."""
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return json_safe(obj.item())
        except Exception:
            return obj
    return obj


def bench_report(bench: str, *, config: Optional[Mapping] = None,
                 metrics: Optional[Mapping] = None,
                 phases: Optional[Mapping] = None,
                 counters: Optional[Mapping] = None) -> Dict[str, Any]:
    """Assemble a schema-conformant report dict (validated on build)."""
    rep = {
        "schema": SCHEMA,
        "bench": str(bench),
        "config": json_safe(dict(config or {})),
        "metrics": json_safe(dict(metrics or {})),
        "phases": {str(k): float(v) for k, v in dict(phases or {}).items()},
        "counters": {str(k): int(v)
                     for k, v in dict(counters or {}).items()},
    }
    validate_report(rep)
    return rep


def validate_report(rep: Mapping) -> None:
    """Raise ValueError unless ``rep`` conforms to ``repro.bench/1``."""
    errs = []
    if rep.get("schema") != SCHEMA:
        errs.append(f"schema is {rep.get('schema')!r}, want {SCHEMA!r}")
    if not isinstance(rep.get("bench"), str) or not rep.get("bench"):
        errs.append("bench must be a non-empty string")
    for key in ("config", "metrics", "phases", "counters"):
        if not isinstance(rep.get(key), dict):
            errs.append(f"{key} must be a dict "
                        f"(got {type(rep.get(key)).__name__})")
    if not errs:
        for k, v in rep["phases"].items():
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not math.isfinite(float(v)) or v < 0:
                errs.append(f"phases[{k!r}] must be a finite ms float >= 0")
        for k, v in rep["counters"].items():
            if not isinstance(v, int) or isinstance(v, bool):
                errs.append(f"counters[{k!r}] must be an int")
    if errs:
        raise ValueError("BenchReport schema violation:\n  "
                         + "\n  ".join(errs))


def write_report(path: str, rep: Mapping) -> str:
    """Validate and write a report; returns the path."""
    validate_report(rep)
    with open(path, "w") as f:
        json.dump(json_safe(dict(rep)), f, indent=2)
    return path


def phase_coverage(rep: Mapping, wall_ms: float) -> float:
    """Fraction of ``wall_ms`` the report's phases account for.

    The attribution-honesty gate: ``--check`` paths require
    ``phase_coverage(rep, wall) >= 0.9`` so a bench cannot claim a
    breakdown that leaves the dominant cost unattributed.
    """
    if wall_ms <= 0:
        return 1.0
    return sum(rep["phases"].values()) / wall_ms

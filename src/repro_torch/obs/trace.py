"""Phase-span tracer: nested monotonic-clock spans with Chrome-trace export.

The tracer is a process-global, thread-aware span recorder. Design
constraints (DESIGN.md §9):

- **Allocation-free when disabled.** ``span(name)`` returns a singleton
  null context manager when tracing is off — no object is allocated, no
  clock is read. Hot loops (the MD step) may therefore leave their span
  calls in place permanently. Callers that want zero overhead must not
  pass kwargs at the call site (building the kwargs dict allocates
  before the disabled check can run); the instrumented hot paths in this
  repo pass the name only.
- **Nesting by thread-local stack.** Spans carry a depth and a parent
  name so the Chrome-trace export reconstructs the tree; reentrancy
  (same span name nested inside itself) is allowed and preserved.
- **Honest device attribution.** CUDA launches are async: a span around
  a kernel launch measures enqueue time only. Instrumented device phases
  call ``torch.cuda.synchronize()`` *inside* their span **only when
  tracing is enabled** (see :func:`sync`), so enabled traces attribute
  device time to the phase that launched it while disabled runs keep the
  launch queue full.

Spans are recorded into a bounded global buffer (oldest dropped past
``MAX_SPANS``) and exported either as ``phase_totals()`` (flat
``{name: ms}`` aggregation, the form benches embed in BenchReport) or as
Chrome-trace JSON (``chrome_trace()`` / ``write_chrome_trace()``), which
loads in ``chrome://tracing`` and Perfetto.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "span", "traced", "enable", "disable", "enabled", "clear",
    "spans", "phase_totals", "chrome_trace", "write_chrome_trace",
    "MAX_SPANS", "sync",
]

# Bounded so a long-running traced service cannot grow without limit;
# oldest spans are dropped once the buffer is full.
MAX_SPANS = 200_000

_enabled = False
_lock = threading.Lock()
_spans: List[Dict[str, Any]] = []
_dropped = 0
_tls = threading.local()


class _NullSpan:
    """Singleton no-op context manager returned while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kwargs):  # parity with _Span; drops everything
        return self


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_t0", "_depth", "_parent")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.args = args

    def tag(self, **kwargs):
        """Attach tags to an open span (cheap: only runs when enabled)."""
        if self.args is None:
            self.args = {}
        self.args.update(kwargs)
        return self

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._depth = len(stack)
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _tls.stack.pop()
        rec = {
            "name": self.name,
            "cat": self.cat,
            "t0": self._t0,
            "dur": t1 - self._t0,
            "depth": self._depth,
            "parent": self._parent,
            "tid": threading.get_ident(),
        }
        if self.args:
            rec["args"] = self.args
        global _dropped
        with _lock:
            if len(_spans) >= MAX_SPANS:
                del _spans[0: MAX_SPANS // 10]
                _dropped += MAX_SPANS // 10
            _spans.append(rec)
        return False


def span(name: str, cat: str = "phase", **args):
    """Open a phase span. Returns a no-op singleton when tracing is off.

    Usage::

        with obs.span("md.finish"):
            arrays = finish(...)

    For zero-overhead-when-disabled call sites, pass only ``name`` (and
    optionally ``cat``); kwargs are evaluated by the caller before the
    enabled check and therefore allocate.
    """
    if not _enabled:
        return _NULL
    return _Span(name, cat, args or None)


def traced(name: Optional[str] = None, cat: str = "phase") -> Callable:
    """Decorator form: wrap a function body in a span.

    ``@traced`` or ``@traced("custom.name")``. The enabled check runs
    per call, so decorating a function keeps it allocation-free while
    tracing is off.
    """
    def deco(fn: Callable) -> Callable:
        label = name or f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            with _Span(label, cat, None):
                return fn(*a, **kw)
        return wrapper

    if callable(name):  # bare @traced
        fn, name = name, None
        return deco(fn)
    return deco


def sync(device) -> None:
    """Wait for `device`'s queued work, only while tracing is enabled.

    Called at the end of a device phase inside its span: with tracing
    off it returns at once and the launches stay asynchronous."""
    if not _enabled:
        return
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def enable() -> None:
    """Turn span recording on (process-global)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn span recording off. Already-recorded spans are kept."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop all recorded spans (does not change the enabled flag)."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def spans() -> List[Dict[str, Any]]:
    """Snapshot of recorded spans (copies the list, not the records)."""
    with _lock:
        return list(_spans)


def phase_totals(prefix: str = "") -> Dict[str, float]:
    """Aggregate recorded spans into flat ``{name: total_ms}``.

    Only **top-level occurrences** of each name are summed: a span whose
    parent has the same name (direct recursion) is skipped so reentrant
    phases are not double-counted. Different names nest freely —
    ``plan.build`` deliberately includes its ``plan.tree_build`` child,
    mirroring the call tree. ``prefix`` filters by name prefix.
    """
    totals: Dict[str, float] = {}
    for rec in spans():
        name = rec["name"]
        if prefix and not name.startswith(prefix):
            continue
        if rec.get("parent") == name:
            continue
        totals[name] = totals.get(name, 0.0) + rec["dur"] * 1e3
    return totals


def chrome_trace(process_name: str = "repro_torch") -> Dict[str, Any]:
    """Render recorded spans as a Chrome-trace / Perfetto JSON object.

    Complete events (``ph: "X"``) with microsecond timestamps relative
    to the earliest recorded span; loads directly in ``chrome://tracing``
    or https://ui.perfetto.dev.
    """
    recs = spans()
    t_base = min((r["t0"] for r in recs), default=0.0)
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
        "args": {"name": process_name},
    }]
    for r in recs:
        ev = {
            "name": r["name"],
            "cat": r["cat"],
            "ph": "X",
            "ts": (r["t0"] - t_base) * 1e6,
            "dur": r["dur"] * 1e6,
            "pid": os.getpid(),
            "tid": r["tid"],
        }
        if "args" in r:
            ev["args"] = r["args"]
        events.append(ev)
    meta = {"displayTimeUnit": "ms", "traceEvents": events}
    if _dropped:
        meta["metadata"] = {"dropped_spans": _dropped}
    return meta


def write_chrome_trace(path: str, process_name: str = "repro_torch") -> str:
    """Write ``chrome_trace()`` JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(process_name), f)
    return path

"""Build/shape event log: what a run paid outside its steady state.

Port of `repro/obs/events.py`. The reference logs every jit compile;
eager PyTorch traces nothing, so here an event is one of

- ``"build"``   — a CUDA kernel library compiled by `kernels._build`
  (`record_build`; ``fn`` is the library, ``wall_ms`` the nvcc time),
- ``"compile"`` — the first call of a component's executable on a shape
  it has not run before, or a call during which a library was built
  (`log_compiles`): the counterparts of a jit compile, so the MD engine's
  ``compiles`` / ``retraces`` keep their meaning (a capacity growth
  changes the plan's shapes and counts as one).

Every event carries ``kind``, ``fn``, ``key`` (the shape signature or
budget, as a string), ``site``, ``wall_ms``, ``owner`` and ``count``;
owners scope per-object counters in the shared log.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["EventLog", "log", "log_compiles", "record", "record_build",
           "build_count", "owner_token"]

MAX_EVENTS = 50_000

_owner_seq = itertools.count(1)


def owner_token(prefix: str) -> str:
    """Process-unique owner token for scoping entries in the global log.

    Owners must never alias across object lifetimes: the log outlives
    the objects, so an `id()`-derived token can collide when CPython
    reuses a freed address. A monotonic sequence cannot."""
    return f"{prefix}@{next(_owner_seq):x}"


class EventLog:
    """Append-only bounded event log with per-owner filtering."""

    def __init__(self, max_events: int = MAX_EVENTS):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._max = max_events
        self._seq = 0

    def record(self, kind: str, fn: str, key: Any = None,
               site: str = "", wall_ms: float = 0.0,
               owner: Optional[str] = None, count: int = 1,
               **extra: Any) -> Dict[str, Any]:
        ev = {
            "seq": 0, "t": time.time(), "kind": kind, "fn": fn,
            "key": None if key is None else str(key), "site": site,
            "wall_ms": wall_ms, "owner": owner, "count": count,
        }
        if extra:
            ev.update(extra)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._events) >= self._max:
                del self._events[0: self._max // 10]
            self._events.append(ev)
        return ev

    def events(self, owner: Optional[str] = None,
               kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if owner is not None:
            evs = [e for e in evs if e["owner"] == owner]
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def count(self, owner: Optional[str] = None,
              kind: Optional[str] = None) -> int:
        return sum(e["count"] for e in self.events(owner, kind))

    def counters(self, owner: Optional[str] = None) -> Dict[str, int]:
        """Flat ``{kind: total_count}`` for an owner (or globally)."""
        out: Dict[str, int] = {}
        for e in self.events(owner):
            out[e["kind"]] = out.get(e["kind"], 0) + e["count"]
        return out

    def clear(self, owner: Optional[str] = None) -> None:
        with self._lock:
            if owner is None:
                self._events.clear()
            else:
                self._events[:] = [e for e in self._events
                                   if e["owner"] != owner]


#: Process-global log. Components pass an ``owner`` token so their
#: ``stats()`` can be derived from the shared log without cross-talk.
log = EventLog()

_builds = 0   # kernel libraries built in this process (never trimmed)


def record(kind: str, fn: str, **kw: Any) -> Dict[str, Any]:
    """Record an event on the global log (see :meth:`EventLog.record`)."""
    return log.record(kind, fn, **kw)


def record_build(name: str, wall_ms: float) -> None:
    """Log one kernel-library build (called by `kernels._build`)."""
    global _builds
    _builds += 1
    log.record("build", name, site="kernels._build", wall_ms=wall_ms)


def build_count() -> int:
    """Kernel libraries built in this process so far."""
    return _builds


def log_compiles(fn_label: str, fn: Callable, *args: Any,
                 key: Any = None, seen: Optional[set] = None,
                 site: str = "", owner: Optional[str] = None,
                 kind: str = "compile", **kwargs: Any) -> Tuple[Any, bool]:
    """Call ``fn(*args, **kwargs)``; log an event if the call built a
    kernel library or ran a `key` (a shape signature; callable keys are
    evaluated after the call) that the caller's `seen` set lacks.

    Returns ``(result, compiled)``. A steady call reads one integer and
    tests one set membership."""
    builds0 = _builds
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    builds = _builds - builds0
    if callable(key):
        key = key()
    new = seen is not None and key not in seen
    if new:
        seen.add(key)
    if builds or new:
        log.record(kind, fn_label, key=key, site=site,
                   wall_ms=(time.perf_counter() - t0) * 1e3, owner=owner,
                   count=builds + int(new), builds=builds)
    return out, bool(builds or new)

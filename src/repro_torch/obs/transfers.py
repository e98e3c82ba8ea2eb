"""Host<->device transfers and host waits of a callable, from the profiler.

The port's twin of `repro/launch/hlo_analysis.py:count_transfers`. The
reference counts host transfers in a compiled program's HLO text; the
port runs eagerly, so it counts what a run of the callable does, from a
`torch.profiler` trace (CPU and CUDA activities): the memcpy events by
kind (HtoD, DtoH, DtoD) with their bytes, the runtime's synchronizing
calls (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) and the kernels. A warm execute should show
no DtoH and no HtoD; an MD refit step one DtoH (the drift).

The parsing is a pure function over the trace's event records
(`count_transfer_events`), so it is tested on records built by hand. On
the CPU there is no device activity and every count is 0.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.profiler import record_function

#: The record_function span around the counted call.
_WINDOW = "repro_torch.count_transfers"

MEMCPY_KINDS = ("HtoD", "DtoH", "DtoD")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def count_transfer_events(events: Iterable[Dict[str, Any]],
                          window: Optional[Tuple[float, float]] = None
                          ) -> Dict:
    """Counts over Chrome-trace event records (``name``, ``cat``,
    ``args``, ``ts``): ``{"HtoD": {"count", "bytes"}, "DtoH": ...,
    "DtoD": ..., "syncs": {call: count}, "kernels": n}``. A memcpy's
    kind is read from its name ("Memcpy DtoH (Device -> Pageable)"), its
    size from ``args["bytes"]``. With `window` (ts from, ts to) a
    runtime call on the host counts only inside it; device activity,
    which runs after the host returns, always counts."""
    out = {k: {"count": 0, "bytes": 0} for k in MEMCPY_KINDS}
    out["syncs"] = {c: 0 for c in SYNC_CALLS}
    out["kernels"] = 0
    for ev in events:
        name, cat = ev.get("name", ""), ev.get("cat", "")
        if window is not None and name in out["syncs"] and not (
                window[0] <= ev.get("ts", window[0]) <= window[1]):
            continue
        if cat == "gpu_memcpy" or name.startswith("Memcpy "):
            kind = next((k for k in MEMCPY_KINDS if k in name), None)
            if kind is not None:
                out[kind]["count"] += 1
                out[kind]["bytes"] += int((ev.get("args") or {})
                                          .get("bytes", 0))
        elif cat == "kernel":
            out["kernels"] += 1
        elif name in out["syncs"]:
            out["syncs"][name] += 1
    return out


def count_transfers(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict]:
    """Run ``fn(*args, **kwargs)`` under the profiler and count its
    transfers and waits (`count_transfer_events`); returns (fn's
    result, counts). The device is drained before and after, so the
    trace holds this call's work and nothing else's."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    if cuda:
        # lint: disable=OB001 — draining the queue is the measurement
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(_WINDOW):
            out = fn(*args, **kwargs)
        if cuda:
            # lint: disable=OB001 — the call's device work must be in
            # the trace (outside the window: not counted as the call's)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    win = next(((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                if e.get("name") == _WINDOW), None)
    return out, count_transfer_events(events, win)

"""`repro_torch.obs` — phase spans, the build/shape event log, occupancy.

- :mod:`repro_torch.obs.trace` — nested phase-span tracer with
  Chrome-trace export; allocation-free no-ops while disabled.
- :mod:`repro_torch.obs.events` — kernel-library builds and first-seen
  shapes (the port's counterpart of the reference's compile log).
- :mod:`repro_torch.obs.occupancy` — device-side occupancy counters and
  padded-vs-real utilization of a plan's packed arrays.
"""
from repro_torch.obs.trace import (  # noqa: F401
    span, traced, enable, disable, enabled, clear,
    spans, phase_totals, chrome_trace, write_chrome_trace, sync,
)
from repro_torch.obs import events  # noqa: F401
from repro_torch.obs.occupancy import (  # noqa: F401
    occupancy_counters, static_occupancy,
)

__all__ = [
    "span", "traced", "enable", "disable", "enabled", "clear",
    "spans", "phase_totals", "chrome_trace", "write_chrome_trace", "sync",
    "events", "occupancy_counters", "static_occupancy",
]

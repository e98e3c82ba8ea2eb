"""`repro_torch.obs` — phase spans and host-side occupancy.

- :mod:`repro_torch.obs.trace` — nested phase-span tracer with
  Chrome-trace export; allocation-free no-ops while disabled.
- :mod:`repro_torch.obs.occupancy` — padded-vs-real utilization of a
  plan's packed arrays.
"""
from repro_torch.obs.trace import (  # noqa: F401
    span, traced, enable, disable, enabled, clear,
    spans, phase_totals, chrome_trace, write_chrome_trace, sync,
)
from repro_torch.obs.occupancy import static_occupancy  # noqa: F401

__all__ = [
    "span", "traced", "enable", "disable", "enabled", "clear",
    "spans", "phase_totals", "chrome_trace", "write_chrome_trace", "sync",
    "static_occupancy",
]

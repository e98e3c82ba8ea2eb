"""Host-side capacity utilization of a plan's packed arrays.

Port of `static_occupancy` from `repro/obs/occupancy.py`: padded-vs-real
points, leaf slots and list lanes straight from the plan's array shapes.
It feeds ``plan.stats()["occupancy"]``. The reference's device-side
counters (`occupancy_counters`) ride on the MD finish pass and come with
the dynamics slice.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["static_occupancy"]


def _numel(a) -> int:
    n = getattr(a, "numel", None)
    return int(n()) if callable(n) else int(a.size)


def static_occupancy(plan) -> Dict[str, float]:
    """Host-side padded-vs-real utilization from a plan's array shapes.

    Works on any object with ``arrays`` (the packed dict of numpy arrays
    or torch tensors) plus ``num_targets`` / ``num_sources``; extra keys
    appear when the corresponding arrays exist. Reading a count off a
    CUDA tensor waits for the device: call it outside timed loops.
    """
    arrays = plan.arrays
    out: Dict[str, float] = {}

    tgt = arrays.get("tgt_batched")
    if tgt is not None:
        slots = 1  # all dims but the trailing xyz axis are target slots
        for d in tgt.shape[:-1]:
            slots *= int(d)
        out["target_slots"] = float(slots)
        out["target_slot_occupancy"] = (
            float(getattr(plan, "num_targets", 0)) / slots if slots else 0.0)

    for name, key in (("leaf_gather", "leaf_slot_occupancy"),
                      ("approx_idx", "approx_lane_occupancy"),
                      ("direct_idx", "direct_lane_occupancy"),
                      ("skin_direct", "skin_direct_lane_occupancy")):
        a = arrays.get(name)
        if a is not None and _numel(a):
            out[key] = float((a >= 0).sum()) / _numel(a)
    return out

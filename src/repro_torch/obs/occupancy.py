"""Device-side occupancy counters and host-side capacity utilization.

Port of `repro/obs/occupancy.py`:

- :func:`occupancy_counters` computes 0-d device tensors from a plan's
  packed arrays (no host sync); the MD engine computes them in its
  finish pass when ``profile=True``. It re-runs the runtime MAC gate on
  the inputs `_skin_routed_lists` sees, so skin accept/demote rates
  describe the routing the force evaluation used, and reports the
  masked-lane waste of the effective lists.
- :func:`static_occupancy`: padded-vs-real points, leaf slots and list
  lanes straight from the plan's array shapes. It feeds
  ``plan.stats()["occupancy"]``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["occupancy_counters", "static_occupancy"]


def _frac(num, den):
    return num.to(torch.float32) / max(int(den), 1) \
        if not isinstance(den, torch.Tensor) \
        else num.to(torch.float32) / den.clamp(min=1).to(torch.float32)


def occupancy_counters(arrays: Dict[str, Any], *, theta: float,
                       space, skin: float = 0.0) -> Dict[str, Any]:
    """Occupancy/waste counters over a plan's packed arrays, as 0-d
    device tensors:

    - ``target_slot_occupancy``: real targets / padded target slots,
    - ``approx_lane_occupancy`` / ``direct_lane_occupancy``: active
      (non ``-1``) lanes over the *effective* routed lists,
    - ``masked_lane_waste``: 1 - active/total over both lanes,
    - with ``skin > 0``: ``skin_pairs``, ``skin_accept_rate``,
      ``skin_demote_rate``: how the runtime MAC gate routed the
      Verlet-skin dual lists."""
    tgt_mask = arrays["tgt_mask"]
    counters: Dict[str, Any] = {
        "target_slot_occupancy": tgt_mask.to(torch.float32).mean(),
    }
    approx_idx = arrays["approx_idx"]
    direct_idx = arrays["direct_idx"]
    if skin > 0.0:
        from repro_torch.core.eval import _skin_routed_lists
        from repro_torch.kernels import ops as _ops

        bc, bhw, rb, has = _ops.batch_boxes(arrays["tgt_batched"], tgt_mask)
        gate_a = _ops.mac_gate(approx_idx, bc, bhw, rb, has,
                               arrays["node_lo"], arrays["node_hi"],
                               theta=theta, space=space)
        skin_slot = (arrays["approx_skin"] != 0) & (approx_idx >= 0)
        skin_pairs = skin_slot.sum()
        skin_accept = (skin_slot & gate_a).sum()
        counters["skin_pairs"] = skin_pairs
        counters["skin_accept_rate"] = _frac(skin_accept, skin_pairs)
        counters["skin_demote_rate"] = _frac(skin_pairs - skin_accept,
                                             skin_pairs)
        approx_idx, direct_idx = _skin_routed_lists(arrays, theta, space)

    a_active = (approx_idx >= 0).sum()
    d_active = (direct_idx >= 0).sum()
    a_total, d_total = approx_idx.numel(), direct_idx.numel()
    counters["approx_lane_occupancy"] = _frac(a_active, a_total)
    counters["direct_lane_occupancy"] = _frac(d_active, d_total)
    counters["masked_lane_waste"] = 1.0 - _frac(a_active + d_active,
                                                a_total + d_total)
    return counters


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

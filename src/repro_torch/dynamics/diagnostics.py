"""Physical diagnostics of an MD trajectory: energy, momentum, temperature.

Port of `repro/dynamics/diagnostics.py`. The scalars are reduced on the
device and read in one transfer, only at the cadence the caller asks for
(``Simulation.run(record_every=...)``), so diagnostics add no host sync
to the steps between records.

Conventions: k_B = 1; the potential energy of a pairwise-interacting
system is U = 1/2 sum_i q_i phi_i (each pair counted once); temperature
is the equipartition estimate T = 2 KE / (3 N).
"""
from __future__ import annotations

from typing import Dict, List

import torch

_SCALARS = ("kinetic", "potential", "energy", "momentum_norm",
            "temperature", "max_speed", "max_force")


def summarize(state, charges, masses) -> Dict[str, float]:
    """One device reduction -> host floats for a single state."""
    v, f = state.v, state.f
    mass = torch.as_tensor(masses, dtype=v.dtype, device=v.device)
    if mass.dim() == 1:
        mass = mass[:, None]
    q = torch.as_tensor(charges, dtype=state.phi.dtype, device=v.device)
    v2 = (v * v).sum(-1)
    # sum_i m_i |v_i|^2 (per-particle masses as an (N, 1) column)
    ke = 0.5 * (mass.reshape(-1) * v2).sum() if mass.dim() else \
        0.5 * mass * v2.sum()
    pe = 0.5 * (q * state.phi).sum()
    mom = (mass * v).sum(0)
    n = v.shape[0]
    vals = torch.stack([
        ke, pe, ke + pe, torch.sqrt((mom * mom).sum()),
        2.0 * ke / (3.0 * n), torch.sqrt(v2.max()),
        torch.sqrt((f * f).sum(-1).max())] + list(mom)).tolist()
    out = dict(zip(_SCALARS, vals))
    out["momentum"] = vals[len(_SCALARS):]
    return out


class EnergyLog:
    """Accumulates per-step summaries; reports relative energy drift.

    Drift is |E(t) - E(0)| / max(|E(0)|, eps), the standard figure of
    merit for symplectic integrators (bounded and small for velocity
    Verlet at a stable dt; growing when dt is too large or the forces
    are inconsistent with the potential)."""

    def __init__(self):
        self.records: List[Dict[str, float]] = []

    def record(self, step: int, summary: Dict[str, float]) -> None:
        self.records.append(dict(summary, step=step))

    @property
    def steps(self) -> List[int]:
        return [int(r["step"]) for r in self.records]

    def drift(self) -> float:
        """Max relative total-energy drift over the logged window."""
        if len(self.records) < 2:
            return 0.0
        e0 = self.records[0]["energy"]
        scale = max(abs(e0), 1e-30)
        return max(abs(r["energy"] - e0) for r in self.records) / scale

    def momentum_drift(self) -> float:
        """Max absolute growth of |total momentum| over the logged window
        (unscaled: compare only across runs of the same system)."""
        if len(self.records) < 2:
            return 0.0
        p0 = self.records[0]["momentum_norm"]
        return max(abs(r["momentum_norm"] - p0) for r in self.records)

    def last(self) -> Dict[str, float]:
        return self.records[-1] if self.records else {}

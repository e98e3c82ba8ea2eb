"""Device-resident MD dynamics over treecode plans (port of `repro.dynamics`).

    Simulation (engine.py)       refit-vs-rebuild policy, capacity-stable
        |                        replans, counters, checkpointing
    Integrator (integrators.py)  velocity Verlet / leapfrog / Langevin,
        |                        split around the force evaluation
    PlanAdapter (refit.py)       device tree refit + input-order forces
        |
    Plan (core.api)              execute / potential_and_forces / replan

Quick start (``device="cpu"`` runs the plain PyTorch path; leave it out
to run on the card)::

    from repro_torch.core.api import TreecodeConfig, TreecodeSolver
    from repro_torch.dynamics import Simulation

    plan = TreecodeSolver(TreecodeConfig(theta=0.8, degree=6),
                          device="cpu").plan(x0)
    sim = Simulation(plan, charges, dt=2e-4, refit_interval=25)
    sim.run(200, record_every=10)
    sim.stats()       # refits / rebuilds / retraces / drift budget
    sim.log.drift()   # relative energy drift
"""
from repro_torch.dynamics.diagnostics import EnergyLog, summarize
from repro_torch.dynamics.engine import Simulation
from repro_torch.dynamics.integrators import (Integrator, MDState,
                                              get_integrator, initial_state,
                                              langevin, leapfrog,
                                              registered_integrators,
                                              velocity_verlet)
from repro_torch.dynamics.refit import (PlanAdapter, ShardedAdapter,
                                        make_adapter, max_drift,
                                        refit_sharded_arrays,
                                        refit_single_arrays,
                                        refresh_slacks_sharded,
                                        refresh_slacks_single)

__all__ = [
    "EnergyLog", "Integrator", "MDState", "PlanAdapter", "ShardedAdapter",
    "Simulation", "get_integrator", "initial_state", "langevin",
    "leapfrog", "make_adapter", "max_drift", "refit_sharded_arrays",
    "refit_single_arrays", "refresh_slacks_sharded",
    "refresh_slacks_single", "registered_integrators", "summarize",
    "velocity_verlet",
]

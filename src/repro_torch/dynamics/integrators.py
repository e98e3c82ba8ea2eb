"""Symplectic and stochastic integrators with device-resident steps.

Port of `repro/dynamics/integrators.py`. Every integrator is split around
the single force evaluation of its step:

    state' = post(pre(state), phi, forces_at(pre(state).x))

`pre` advances positions to the point where forces are needed; `post`
finishes the step with the fresh forces. Both are tensor functions over
`MDState`, so forces never visit the host between half-kicks, and the
engine decides refit or rebuild at the new positions before evaluating
forces there.

Schemes:
  - velocity_verlet: kick-drift-kick; forces cached across steps (one
    evaluation per step).
  - leapfrog: position Verlet (drift-kick-drift); forces evaluated at the
    midpoint, never cached across steps.
  - langevin: BAOAB splitting (Leimkuhler & Matthews) with exact OU noise;
    samples the NVT ensemble at temperature T (k_B = 1). The noise comes
    from the state's `torch.Generator`, so it cannot match the
    reference's `jax.random` bits: compare distributions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch


class MDState(NamedTuple):
    """Device-resident dynamic state, all in input (user) particle order."""

    x: torch.Tensor    # (N, 3) positions
    v: torch.Tensor    # (N, 3) velocities
    f: torch.Tensor    # (N, 3) forces at x (or at the last force point)
    phi: torch.Tensor  # (N,)   potentials accompanying f
    key: torch.Generator  # Langevin noise, on the state's device (a
    #                       tuple of them, one a replica, when stacked)


@dataclasses.dataclass(frozen=True)
class Integrator:
    """A step scheme split around its force evaluation.

    pre(state, dt, inv_m)  -> state with x advanced to the force point
                              (and any velocity/noise sub-steps applied);
    post(state, phi, f, dt, inv_m) -> completed state carrying phi/f.
    """

    name: str
    pre: Callable
    post: Callable
    uses_cached_forces: bool = True  # pre reads state.f from the last step
    # True when state.phi/f correspond to the step-end positions (velocity
    # Verlet, BAOAB). Position Verlet evaluates forces at the midpoint, so
    # the engine refreshes phi before energy diagnostics.
    phi_at_step_end: bool = True


def _vv_pre(state: MDState, dt, inv_m) -> MDState:
    v = state.v + (0.5 * dt) * state.f * inv_m
    return state._replace(x=state.x + dt * v, v=v)


def _vv_post(state: MDState, phi, f, dt, inv_m) -> MDState:
    return state._replace(v=state.v + (0.5 * dt) * f * inv_m, f=f, phi=phi)


def velocity_verlet() -> Integrator:
    return Integrator("velocity_verlet", _vv_pre, _vv_post)


def _lf_pre(state: MDState, dt, inv_m) -> MDState:
    return state._replace(x=state.x + (0.5 * dt) * state.v)


def _lf_post(state: MDState, phi, f, dt, inv_m) -> MDState:
    v = state.v + dt * f * inv_m
    return state._replace(x=state.x + (0.5 * dt) * v, v=v, f=f, phi=phi)


def leapfrog() -> Integrator:
    return Integrator("leapfrog", _lf_pre, _lf_post,
                      uses_cached_forces=False, phi_at_step_end=False)


def _normal(like: torch.Tensor, key) -> torch.Tensor:
    """Standard normal noise shaped like `like` from generator `key`. A
    tuple of generators (an ensemble's stacked state, replicas along the
    leading axis) draws each replica's rows from its own."""
    if isinstance(key, tuple):
        return torch.stack([_normal(row, k) for row, k in zip(like, key)])
    return torch.randn(like.shape, generator=key, dtype=like.dtype,
                       device=like.device)


def langevin(friction: float = 1.0, temperature: float = 0.1) -> Integrator:
    """BAOAB: B(dt/2) A(dt/2) O(dt) A(dt/2) [force] B(dt/2).

    The O sub-step is the exact Ornstein-Uhlenbeck update
    v <- c v + sqrt((1 - c^2) T / m) xi,  c = exp(-friction dt),
    so the scheme is stable for any friction and samples NVT with leading
    O(dt^2) configurational error."""
    gamma = float(friction)
    temp = float(temperature)

    def pre(state: MDState, dt, inv_m) -> MDState:
        v = state.v + (0.5 * dt) * state.f * inv_m           # B
        x = state.x + (0.5 * dt) * v                          # A
        c = math.exp(-gamma * dt)
        xi = _normal(v, state.key)
        sigma = torch.sqrt((1.0 - c * c) * temp * inv_m)
        v = c * v + sigma * xi                                # O
        x = x + (0.5 * dt) * v                                # A
        return state._replace(x=x, v=v)

    def post(state: MDState, phi, f, dt, inv_m) -> MDState:
        return state._replace(v=state.v + (0.5 * dt) * f * inv_m,  # B
                              f=f, phi=phi)

    return Integrator(f"langevin(gamma={gamma},T={temp})", pre, post)


_FACTORIES = {
    "velocity_verlet": velocity_verlet,
    "leapfrog": leapfrog,
    "langevin": langevin,
}


def get_integrator(integrator, **params) -> Integrator:
    """Resolve a name (with factory params) or pass through an instance."""
    if isinstance(integrator, Integrator):
        if params:
            raise ValueError("params only apply to integrator names")
        return integrator
    if integrator not in _FACTORIES:
        raise KeyError(f"unknown integrator {integrator!r}; "
                       f"have {sorted(_FACTORIES)}")
    return _FACTORIES[integrator](**params)


def registered_integrators() -> tuple:
    return tuple(sorted(_FACTORIES))


def initial_state(x, v: Optional[torch.Tensor] = None, *, seed: int = 0,
                  dtype=None, device=None) -> MDState:
    """Device state from host or device positions (forces filled by the
    engine's first evaluation); the noise generator is seeded from
    `seed`."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    v = torch.zeros_like(x) if v is None else torch.as_tensor(
        v, dtype=x.dtype, device=x.device)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    return MDState(x=x, v=v, f=torch.zeros_like(x),
                   phi=x.new_zeros((x.shape[0],)), key=gen)

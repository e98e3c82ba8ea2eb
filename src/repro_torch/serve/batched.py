"""Batched ensemble evaluation: W treecode systems, one launch per kernel.

Port of `repro/serve/batched.py`. `EnsemblePlan` stacks W
capacity-padded single-system plans along a leading systems axis. Every
member is padded into ONE shared point-budgeted `Capacities` budget, so
the members' arrays have identical shapes and stack into (W, ...)
tensors; the executors of `core.eval` then run the whole pipeline on the
stack, with one modified-charge call and one launch per lane for all W
systems (the kernels' systems axis). Replica ensembles, kernel parameter
scans and mixed many-small-box workloads all run that way.

    plan = EnsemblePlan.build(config, [x0, x1, x2])     # mixed sizes OK
    phi = plan.execute([q0, q1, q2])                    # (W, num_targets)
    phi, F = plan.potential_and_forces([q0, q1, q2])
    plan.split(phi)                                     # per-system views

Per-system charges and kernel parameter values are tensors, so a
5-value kappa scan over one geometry is

    plan = EnsemblePlan.build(cfg, [x] * 5)
    phi = plan.execute([q] * 5,
                       kernel_params=[{"kappa": k} for k in kappas])

and, with the charges and kappas already on the card, never waits for
the host. `EnsembleMD` is the batched-MD hook: a replica ensemble
advances with a device tree refit and the ensemble forces every step.

The request-level front (shape bucketing, flush policy, futures) lives
in `repro_torch.serve.service`. Like `core.api`, the plans live on the
CUDA device unless built with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import eval as _eval
from repro_torch.core.api import (TreecodeConfig, _host, _resolve_dtype,
                                  resolve_device)
from repro_torch.core.potentials import Kernel
from repro_torch.dynamics.integrators import (MDState, get_integrator,
                                              initial_state)
from repro_torch.dynamics.refit import refit_single_arrays
from repro_torch.lint import runtime as _rt


def _member_need(inner: _eval.Plan) -> dict:
    """A member's needs dict WITH the explicit point-budget keys (the
    only way point budgets enter a `Capacities`)."""
    return dict(_eval._plan_dims(inner), num_targets=inner.num_targets,
                num_sources=inner.num_sources)


def _max_need(needs: Sequence[dict]) -> dict:
    """Element-wise max over needs dicts (ragged tuples zero-extended),
    so the initial shared budget fits every member without a geometric
    growth's overshoot."""
    out = dict(needs[0])
    for n in needs[1:]:
        for k, v in n.items():
            cur = out[k]
            if isinstance(v, tuple):
                d = max(len(cur), len(v))
                out[k] = tuple(
                    max(cur[i] if i < len(cur) else 0,
                        v[i] if i < len(v) else 0) for i in range(d))
            else:
                out[k] = max(cur, v)
    return out


def _stack_members(members: Sequence[_eval.Plan], width: int) -> dict:
    """Shape-identical member arrays stacked along a leading systems
    axis; the dummy slots repeat the last member (their charges are zero
    and their outputs are sliced away)."""
    mems = list(members) + [members[-1]] * (width - len(members))
    out = {}
    for k, v in mems[0].arrays.items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.stack([m.arrays[k][i] for m in mems])
                           for i in range(len(v)))
        else:
            out[k] = torch.stack([m.arrays[k] for m in mems])
    return out


def _stack_leaves(trees: Sequence, dtype, device):
    """Parameter trees of one structure -> one tree whose leaves carry a
    leading systems axis. Python numbers go up in one transfer per leaf;
    tensors already on `device` are stacked there."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return tuple(_stack_leaves([t[i] for t in trees], dtype, device)
                     for i in range(len(first)))
    if any(isinstance(v, torch.Tensor) for v in trees):
        return torch.stack([torch.as_tensor(v, dtype=dtype, device=device)
                            for v in trees])
    return torch.as_tensor(np.asarray(trees), dtype=dtype, device=device)


def _broadcast_leaves(tree, width: int, dtype, device):
    """A parameter tree with every leaf broadcast over `width` systems."""
    if isinstance(tree, (tuple, list)):
        return tuple(_broadcast_leaves(t, width, dtype, device)
                     for t in tree)
    t = torch.as_tensor(tree, dtype=dtype, device=device)
    return t.expand((width,) + tuple(t.shape))


class EnsemblePlan:
    """Plan-protocol executor over W stacked systems (targets == sources).

    `execute` takes a LIST of per-system charge vectors (or an already
    stacked, padded ``(width, num_sources)`` tensor) and returns stacked
    padded potentials ``(width, num_targets)``; `split` trims them back
    to per-system views. `kernel_params` takes a list (per system), a
    dict (broadcast) or None (the config's defaults).

    All members share the config's statics (kernel, space, theta,
    degree, leaf/batch size, backend, precompute, dtype), which is the
    serving bucket key (`repro_torch.serve.service`). Mixed particle
    counts are fine: the shared budget point-pads them.

    `ensemble_width` fixes the stacked width independently of the number
    of real systems (dummy slots repeat the last member with zero
    charges), so a serving bucket keeps ONE set of shapes across flushes
    of varying occupancy.
    """

    nranks = 1
    strategy = "ensemble"

    def __init__(self, config: TreecodeConfig, kernel: Kernel,
                 members: List[_eval.Plan], capacities: _eval.Capacities,
                 dtype: torch.dtype, ensemble_width: int,
                 positions: Optional[List[np.ndarray]] = None):
        self.config = config
        self.kernel = kernel
        self.members = members
        self.capacities = capacities
        self.dtype = dtype
        self.ensemble_width = ensemble_width
        self.positions = positions
        self.sizes = tuple(m.num_targets for m in members)
        self.arrays = _stack_members(members, ensemble_width)
        self.device = self.arrays["node_lo"].device
        # the kernel's default parameters, broadcast over the width
        self.kernel_params = _broadcast_leaves(kernel.params, ensemble_width,
                                               dtype, self.device)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, config: TreecodeConfig, systems: Sequence,
              *, capacities: Optional[_eval.Capacities] = None,
              ensemble_width: Optional[int] = None,
              kernel: Optional[Kernel] = None,
              headroom: float = 1.0, device=None) -> "EnsemblePlan":
        """Build an ensemble plan over `systems` (a sequence of (N_i, 3)
        position arrays, each its own targets == sources geometry) on
        `device` (CUDA unless ``device="cpu"``).

        Each member is a host build (`core.eval.prepare_plan`, the upward
        pass's tables under ``precompute="hierarchical"``) whatever the
        config's `build_backend`. `capacities` seeds the shared budget (a
        serving bucket passes its sticky budget so warm flushes keep
        their shapes); None budgets this build's own needs. Either way
        the budget grows to fit every member (geometrically: a counted
        event when it changes a sticky budget). A budget without point
        budgets gets them at the members' largest counts.

        Fresh budgets are TIGHT (headroom 1.0, base 1): a padded slot
        costs work multiplied by the ensemble width, and serving reuse
        needs equal budgets, not slack. Pass ``headroom > 1`` for
        MD-style drift room instead."""
        systems = [s for s in systems]
        if not systems:
            raise ValueError("EnsemblePlan.build needs at least one system")
        if ensemble_width is not None and ensemble_width < len(systems):
            raise ValueError(
                f"ensemble_width={ensemble_width} < {len(systems)} systems")
        kernel = config.make_kernel() if kernel is None else kernel
        dtype = _resolve_dtype(config, systems[0])
        device = resolve_device(device)

        inners, positions = [], []
        for s in systems:
            pts = _host(s, dtype)
            if pts.ndim != 2 or pts.shape[1] != 3:
                raise ValueError(
                    f"each system must be (N, 3) positions, got {pts.shape}")
            inner = _eval.prepare_plan(
                pts, pts, theta=config.theta, degree=config.degree,
                leaf_size=config.leaf_size,
                batch_size=config.resolved_batch_size(), space=config.space,
                skin=config.skin, device=device)
            if config.precompute == "hierarchical":
                inner = _eval.add_hierarchical_tables(inner)
            inners.append(inner)
            positions.append(pts)

        needs = [_member_need(i) for i in inners]
        if capacities is None:
            caps = _eval.Capacities.for_need(_max_need(needs),
                                             headroom=headroom, base=1)
        else:
            caps = capacities
            if not caps.points_budgeted:
                caps = dataclasses.replace(
                    caps,
                    num_targets=max(n["num_targets"] for n in needs),
                    num_sources=max(n["num_sources"] for n in needs))
        for n in needs:
            caps = caps.grown_to_fit_need(n)

        members = [_eval.pad_plan(i, caps) for i in inners]
        width = ensemble_width if ensemble_width else len(members)
        return cls(config, kernel, members, caps, dtype, width,
                   positions=positions)

    # ------------------------------------------------------------------
    # inputs: charges / weights / params with a systems axis
    # ------------------------------------------------------------------

    @property
    def num_systems(self) -> int:
        return len(self.members)

    @property
    def occupancy(self) -> float:
        return self.num_systems / self.ensemble_width

    @property
    def num_targets(self) -> int:
        """Padded per-system target count (the point budget)."""
        return self.capacities.num_targets

    @property
    def num_sources(self) -> int:
        return self.capacities.num_sources

    @property
    def space(self):
        return self.config.space

    def signature(self) -> Tuple:
        """Shape/dtype signature of the stacked arrays: plans with equal
        signatures share every shape (the warm-bucket test)."""
        return _eval.plan_signature(self)

    def _charges(self, charges) -> torch.Tensor:
        """(width, num_sources) stacked charge slab from a per-system list
        (zero-padded; dummy slots all zero) or a pre-stacked array. A
        list of tensors on the plan's device is packed there; host data
        goes up in one transfer."""
        ns = self.capacities.num_sources
        if isinstance(charges, (list, tuple)):
            if len(charges) != self.num_systems:
                raise ValueError(
                    f"expected {self.num_systems} charge vectors, "
                    f"got {len(charges)}")
            for i, (q, n) in enumerate(zip(charges, self.sizes)):
                if tuple(np.shape(q)) != (n,):
                    raise ValueError(f"system {i} has {n} particles, "
                                     f"charges {tuple(np.shape(q))}")
            if all(isinstance(q, torch.Tensor) for q in charges):
                slab = torch.zeros((self.ensemble_width, ns),
                                   dtype=self.dtype, device=self.device)
                for i, q in enumerate(charges):
                    slab[i, :q.shape[0]] = q
                return slab
            np_dtype = np.float64 if self.dtype == torch.float64 \
                else np.float32
            slab = np.zeros((self.ensemble_width, ns), np_dtype)
            # host payloads go up as one sanctioned transfer
            with _rt.explicit_sync("upload"):
                for i, q in enumerate(charges):
                    slab[i, :len(q)] = _host(q, self.dtype) if isinstance(
                        q, torch.Tensor) else np.asarray(q, np_dtype)
                return torch.as_tensor(slab, device=self.device)
        q = torch.as_tensor(charges, dtype=self.dtype, device=self.device)
        expect = (self.ensemble_width, ns)
        if tuple(q.shape) != expect:
            raise ValueError(
                f"stacked charges must be {expect}, got {tuple(q.shape)}")
        return q

    def _params(self, kernel_params):
        """Per-call kernel parameters with a systems axis. A LIST gives
        per-system values (normalized through the kernel, padded by
        repeating the last entry); a dict or raw tuple broadcasts; None
        uses the config's defaults."""
        if kernel_params is None:
            return self.kernel_params
        if isinstance(kernel_params, list):
            if len(kernel_params) != self.num_systems:
                raise ValueError(
                    f"expected {self.num_systems} kernel_params entries, "
                    f"got {len(kernel_params)}")
            norm = [self.kernel.normalize_params(p) for p in kernel_params]
            norm += [norm[-1]] * (self.ensemble_width - len(norm))
            with _rt.explicit_sync("upload"):   # host values go up
                return _stack_leaves(norm, self.dtype, self.device)
        with _rt.explicit_sync("upload"):
            return _broadcast_leaves(
                self.kernel.normalize_params(kernel_params),
                self.ensemble_width, self.dtype, self.device)

    def split(self, stacked: torch.Tensor) -> List[torch.Tensor]:
        """A stacked output (phi (width, nt) or forces (width, nt, 3))
        trimmed back to per-system views (dummy slots dropped)."""
        return [stacked[i, :n] for i, n in enumerate(self.sizes)]

    # ------------------------------------------------------------------
    # plan protocol
    # ------------------------------------------------------------------

    def execute(self, charges, kernel_params=None) -> torch.Tensor:
        """Stacked potentials (width, num_targets): one modified-charge
        call and one batch-cluster launch per lane for every system.
        Padded target slots are exactly 0; `split` recovers per-system
        input-order potentials."""
        return _eval.ensemble_execute(
            self.arrays, self._charges(charges), self._params(kernel_params),
            **self.config.exec_opts(self.kernel))

    def potential_and_forces(self, charges, weights=None,
                             kernel_params=None):
        """Stacked (phi, F): (width, nt) and (width, nt, 3), one field
        launch per lane. `weights` default to the charges (targets ==
        sources: the physical force on charge q_i); padded slots carry
        zero weights, so their forces are exactly 0."""
        q = self._charges(charges)
        w = q if weights is None else self._charges(weights)
        return _eval.ensemble_potential_and_forces(
            self.arrays, q, w, self._params(kernel_params),
            **self.config.exec_opts(self.kernel))

    def stats(self) -> dict:
        """Ensemble geometry/budget counters (plan-protocol surface)."""
        return dict(
            strategy="ensemble",
            nranks=1,
            num_systems=self.num_systems,
            ensemble_width=self.ensemble_width,
            occupancy=self.occupancy,
            sizes=self.sizes,
            num_targets=self.capacities.num_targets,
            num_sources=self.capacities.num_sources,
            padding_waste=float(np.mean(
                [m.padding_waste for m in self.members])),
            dtype=str(self.dtype).replace("torch.", ""),
            space=repr(self.config.space),
            theta_slack=float(min(m.theta_slack for m in self.members)),
            fold_slack=float(min(m.fold_slack for m in self.members)),
            skin=float(self.config.skin),
            capacity_padded=True,
            capacities=dataclasses.asdict(self.capacities),
        )

    def replan(self, systems, sources=None, *,
               capacities="keep") -> "EnsemblePlan":
        """Rebuild every member for moved or replaced systems under the
        same config, on the same device. `capacities="keep"` (default)
        re-pads into this plan's budget, growing it geometrically on
        overflow, and keeps the ensemble width (grown to fit if more
        systems arrive)."""
        if sources is not None:
            raise ValueError("ensemble plans require targets == sources")
        if capacities == "keep":
            capacities = self.capacities
        width = max(self.ensemble_width, len(systems))
        return EnsemblePlan.build(self.config, systems,
                                  capacities=capacities,
                                  ensemble_width=width, kernel=self.kernel,
                                  device=self.device)


class EnsembleMD:
    """Batched-MD hook: a replica ensemble steps together.

    Minimal by design (the refit-vs-rebuild engine is
    `repro_torch.dynamics.Simulation`): it covers the serving-adjacent
    replica case (many independent systems, one shared budget) where
    every step is a device tree REFIT, topology frozen between `replan`
    calls, exactly a `Simulation` with ``rebuild="never"``. A step is the
    integrator's pre-step, the stacked refit, the ensemble forces (one
    modified-charge call and one field launch per lane for every
    replica) and the post-step. Replica i draws its noise from its own
    `torch.Generator`, seeded from ``seed + i``.

        md = EnsembleMD(plan, charges, dt=1e-3)
        md.run(100)
        xs = md.split_positions()       # per-system positions
    """

    def __init__(self, plan: EnsemblePlan, charges, *, dt: float,
                 velocities=None, masses=1.0,
                 integrator="velocity_verlet",
                 integrator_params: Optional[dict] = None, seed: int = 0):
        self.plan = plan
        self.dt = float(dt)
        self.integrator = get_integrator(integrator,
                                         **(integrator_params or {}))
        self.charges = plan._charges(charges)    # (W, ns) zero-padded
        m = torch.as_tensor(masses, dtype=plan.dtype, device=plan.device)
        inv_m = 1.0 / m
        self._inv_m = inv_m[:, None] if inv_m.dim() == 1 else inv_m
        self.steps = 0
        if plan.positions is None:
            raise ValueError("EnsembleMD needs a plan built via "
                             "EnsemblePlan.build (positions retained)")
        if plan.capacities.num_targets != plan.capacities.num_sources:
            # the refit takes state.x as both the targets it scatters and
            # the sources it gathers
            raise ValueError("batched MD needs num_targets == num_sources "
                             "in the point budget")
        # stacked state: per-system rows padded with zeros (padded rows
        # see zero forces, so they stay exactly at rest)
        nt = plan.capacities.num_targets
        np_dtype = np.float64 if plan.dtype == torch.float64 else np.float32
        xs = np.zeros((plan.ensemble_width, nt, 3), np_dtype)
        vs = np.zeros_like(xs)
        for i, n in enumerate(plan.sizes):
            xs[i, :n] = plan.positions[i]
            if velocities is not None:
                vs[i, :n] = _host(velocities[i], plan.dtype)
        states = [initial_state(xs[i], vs[i], seed=seed + i,
                                dtype=plan.dtype, device=plan.device)
                  for i in range(plan.ensemble_width)]
        self.state = MDState(
            *(torch.stack([getattr(s, f) for s in states])
              for f in ("x", "v", "f", "phi")),
            key=tuple(s.key for s in states))
        self._opts = plan.config.exec_opts(plan.kernel)
        self.arrays = refit_single_arrays(plan.arrays, self.state.x)
        phi, f = self._forces(self.arrays)
        self.state = self.state._replace(phi=phi, f=f)

    def _forces(self, arrays):
        q = self.charges
        return _eval.potential_and_forces(arrays, q, q,
                                          self.plan.kernel_params,
                                          **self._opts)

    def step(self) -> MDState:
        """One batched integration step (W force sums, one launch per
        kernel); the integrator's half-steps take the stacked state
        whole, each replica's noise drawn from its own generator."""
        s1 = self.integrator.pre(self.state, self.dt, self._inv_m)
        self.arrays = refit_single_arrays(self.arrays, s1.x)
        phi, f = self._forces(self.arrays)
        self.state = self.integrator.post(s1, phi, f, self.dt, self._inv_m)
        self.steps += 1
        return self.state

    def run(self, steps: int) -> "EnsembleMD":
        for _ in range(steps):
            self.step()
        return self

    def split_positions(self) -> List[torch.Tensor]:
        return self.plan.split(self.state.x)

    def split_velocities(self) -> List[torch.Tensor]:
        return self.plan.split(self.state.v)

"""Device-resident MD engine over treecode plans: refit when you can,
rebuild when you must, keep every shape while the capacities hold.

Port of `repro/dynamics/engine.py`, over single-device and sharded plans.
One `Simulation.step()` is:

    1. advance: integrator pre-step (positions move to the force
       point) and the max particle displacement since the LAST force
       evaluation (minimum image under periodic spaces), a 0-d device
       tensor. Reading it is the step's one host sync: the slacks the
       previous finish computed ride in the same transfer.
    2. host decision: REFIT while that per-step drift fits BOTH live
       budgets refreshed from the previous refit's boxes (DESIGN.md §4):

           2*sqrt(3)*(1+theta) * drift < safety * theta_slack   and
           4 * drift                   < safety * fold_slack

       and the max interval K has not elapsed; otherwise REBUILD the
       tree, re-padded into the plan's fixed `Capacities`: on the host
       (the paper's CPU setup phase) or, for ``build_backend="device"``
       plans, on the device from the live device positions. Verlet-skin
       pairs (plans built with ``skin > 0``) are gated inside the
       executors and never constrain the budgets.
    3. finish: device tree refit -> slack refresh from the refitted
       boxes -> treecode forces (the field kernel, one launch per lane)
       -> integrator post-step. Forces never visit the host.

PyTorch runs eagerly, so where the reference counts jit compiles the
engine counts what eager code pays outside its steady state (events of
`repro_torch.obs.events`): a kernel library built during one of its
calls, or a call on plan shapes that executable has not run before.
``retraces`` are those after step 1: 0 while every rebuild fits the
capacity budget.

With ``async_replan=True`` (device builds) the rebuild is
double-buffered: when a budget is `dispatch_fraction` spent, or the
interval one step from elapsing, the engine dispatches a shadow device
build on a side CUDA stream, behind that step's forces (the reference
dispatches before them; the host's enqueueing then overlaps the card's
force sweep), and keeps refitting on the live plan; the next step swaps
it in (the `plan_swap` span).

Sharded plans (`repro_torch.distributed`) rebuild on the host into their
`ShardedCapacities`; a rebuild that grows the budget re-closes the step's
force and slack functions over the new halo schedule.

The step's host reads go through `repro_torch.lint.runtime.explicit_sync`
(the drift, "drift"; unread slacks, "budgets"), so a refit step under
`no_implicit_syncs()` counts exactly one. ``REPRO_DEBUG_NANS=1`` turns
on the runtime's NaN mode in ``__init__`` (`debug_nans`): every kernel
entry of the step then checks its output.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import torch

from repro_torch.checkpoint.store import Checkpointer
from repro_torch.core.interaction import (fold_drift_rate, theta_drift_rate,
                                          scaled_mac_slack as _scaled_slack)
from repro_torch.dynamics import diagnostics as diag
from repro_torch.dynamics.integrators import (MDState, get_integrator,
                                              initial_state)
from repro_torch.dynamics.refit import make_adapter, max_drift
from repro_torch.lint import runtime as _rt
from repro_torch.obs import events as _events
from repro_torch.obs import trace as _trace
from repro_torch.obs.occupancy import occupancy_counters as _occ_counters

_REBUILD_POLICIES = ("auto", "always", "never")


class Simulation:
    """Time integration of N interacting particles with treecode forces.

    Args:
      plan: a `TreecodeSolver` plan built over the particle positions with
        targets == sources. A plan without capacity padding is re-padded
        (`capacities="auto"`) so replans keep their shapes.
      charges: (N,) source charges q_i (also the force weights).
      dt: time step.
      velocities: (N, 3) initial velocities (default zero).
      masses: scalar or (N,) particle masses.
      integrator: name ("velocity_verlet" | "leapfrog" | "langevin") or
        an `Integrator`; `integrator_params` forwards factory kwargs
        (friction/temperature for langevin).
      seed: seeds the state's noise generator (Langevin).
      refit_interval: K, the max steps between host tree rebuilds.
      drift_safety: fraction of the refreshed slack budgets to spend
        before a drift-triggered rebuild (1.0 = the provable bound).
      rebuild: "auto" (drift trigger + interval), "always" (every step,
        the naive baseline), "never" (trust refit indefinitely).
      checkpointer/checkpoint_every: trajectory snapshots through
        `repro_torch.checkpoint.store.Checkpointer`.
      profile: compute device-side occupancy counters (`repro_torch.obs`)
        in the finish pass; they appear under ``stats()["occupancy"]``.
      async_replan: double-buffer the rebuilds (device build backend,
        rebuild="auto"). When a drift budget is `dispatch_fraction` spent,
        or the interval is one step from elapsing, the engine DISPATCHES
        a shadow device build over the current (wrapped) positions on a
        side CUDA stream without waiting, keeps refitting on the live
        plan, and swaps the shadow in at the next step boundary. The
        swap counts as a rebuild under the cause recorded at dispatch;
        ``rebuild_wait_ms`` is the host time blocked on builds,
        ``rebuild_total_ms`` their end-to-end time.
      dispatch_fraction: fraction of a drift budget spent before a shadow
        build is dispatched (the rest covers the drift while it is in
        flight).
    """

    def __init__(self, plan, charges, *, dt: float,
                 velocities=None, masses=1.0,
                 integrator="velocity_verlet",
                 integrator_params: Optional[dict] = None,
                 seed: int = 0,
                 refit_interval: int = 100,
                 drift_safety: float = 1.0,
                 rebuild: str = "auto",
                 checkpointer: Optional[Checkpointer] = None,
                 checkpoint_every: int = 0,
                 profile: bool = False,
                 async_replan: bool = False,
                 dispatch_fraction: float = 0.5):
        if rebuild not in _REBUILD_POLICIES:
            raise ValueError(f"rebuild must be one of {_REBUILD_POLICIES}")
        if refit_interval < 1:
            raise ValueError("refit_interval must be >= 1")
        self.debug_nans = _rt.enable_debug_nans_if_requested()
        self.dt = float(dt)
        self.refit_interval = int(refit_interval)
        self.drift_safety = float(drift_safety)
        self.rebuild_policy = rebuild
        self.checkpointer = checkpointer
        self.checkpoint_every = int(checkpoint_every)
        self.profile = bool(profile)
        # Owner token scoping this engine's entries in the global event
        # log (repro_torch.obs.events); `_seen` holds the plan shapes each
        # executable has run on (a new one is the counterpart of a
        # compile).
        self.obs_owner = _events.owner_token("Simulation")
        self._seen = {"advance": set(), "finish": set(), "init_forces": set()}
        self._occ_dev = None

        self.adapter = make_adapter(plan)
        if plan.capacities is None:
            plan = plan.replan(self.adapter.positions(), capacities="auto")
            self.adapter = make_adapter(plan)
        self.plan = self.adapter.plan
        self.device = self.plan.device
        dtype = self.plan.dtype
        self.async_replan = bool(async_replan)
        self.dispatch_fraction = float(dispatch_fraction)
        if self.async_replan:
            if rebuild != "auto":
                raise ValueError(
                    "async_replan requires rebuild='auto' (the shadow "
                    "dispatch rides the drift/interval triggers)")
            if not self.adapter.supports_async_rebuild:
                raise ValueError(
                    "async_replan requires a capacity-padded device-"
                    "backend plan (build_backend='device')")
            if not 0.0 < self.dispatch_fraction <= 1.0:
                raise ValueError("dispatch_fraction must be in (0, 1]")
        # The in-flight shadow build (an adapter handle), the rebuild
        # cause recorded at dispatch, and the dispatch call's host ms.
        self._pending = None
        self._pending_cause = None
        self._pending_dispatch_ms = 0.0

        n = self.plan.num_targets
        if self.plan.num_sources != n:
            raise ValueError("dynamics requires targets == sources")
        q = torch.as_tensor(charges, dtype=dtype, device=self.device)
        if tuple(q.shape) != (n,):
            raise ValueError(f"charges must be ({n},), got "
                             f"{tuple(q.shape)}")
        self.charges = q
        self.masses = torch.as_tensor(masses, dtype=dtype, device=self.device)
        inv_m = 1.0 / self.masses
        self._inv_m = inv_m[:, None] if inv_m.dim() == 1 else inv_m

        self.integrator = get_integrator(integrator,
                                         **(integrator_params or {}))
        # Periodic boxes: integrate UNWRAPPED coordinates between host
        # rebuilds (the kernels fold displacements to the minimum image,
        # and continuous positions keep refitted boxes tight); wrap back
        # into the primary cell at every rebuild.
        self.space = self.plan.config.space
        self.state: MDState = initial_state(
            self.adapter.positions(), velocities, seed=seed, dtype=dtype,
            device=self.device)
        self._arrays = self.adapter.arrays
        self._sig = self.adapter.signature()
        # Reference for the per-step drift: the positions of the LAST
        # force evaluation (where the budgets were refreshed).
        self._x_eval_ref = self.state.x
        self._theta = float(self.plan.config.theta)
        self._skin = float(self.adapter.skin)
        # Live budgets: build-time values until the first refresh.
        self._theta_slack = float(self.adapter.theta_slack)
        self._fold_slack = float(self.adapter.fold_slack)
        self._slack_dev = None  # (theta, fold) device scalars, read lazily
        self._slack_fallback = False  # NaN slack seen: interval cadence

        # Counters (stats() surface). Rebuild causes PARTITION the
        # rebuild count: rebuilds == drift + interval + forced, and so do
        # the backends: rebuilds == host + device.
        self.steps = 0
        self.refits = 0
        self.rebuilds = 0
        self.rebuilds_drift = 0
        self.rebuilds_interval = 0
        self.rebuilds_forced = 0
        self.rebuilds_host = 0
        self.rebuilds_device = 0
        # Rebuild wall time: `total` end to end (sync rebuild, or async
        # dispatch + commit), `wait` the part the host was blocked.
        self.rebuild_total_ms = 0.0
        self.rebuild_wait_ms = 0.0
        self.plan_swaps = 0
        self.force_evals = 0
        self.capacity_growths = 0
        self._steps_since_rebuild = 0
        self._last_drift = 0.0
        self._baseline_compiles: Optional[int] = None
        self._make_closures()

        # Initial force evaluation: seeds f/phi for the first kick and for
        # step-0 diagnostics, plus the refreshed budgets.
        self._arrays, self.state, self._slack_dev, self._occ_dev = \
            self._call_logged("init_forces", self._init_forces,
                              "Simulation.__init__", self._arrays,
                              self.state)
        self.adapter.sync_arrays(self._arrays)
        self.force_evals += 1
        self.log = diag.EnergyLog()

    # ------------------------------------------------------------------
    # the step's device functions
    # ------------------------------------------------------------------

    def _make_closures(self):
        integ, dt, inv_m, space = (self.integrator, self.dt, self._inv_m,
                                   self.space)
        adapter, q = self.adapter, self.charges
        # skin-gate rates need the unstacked batch boxes: single device only
        profile, theta = self.profile, self._theta
        skin = self._skin if self.plan.nranks == 1 else 0.0
        # the config (kernel, options) is the same for every replan
        force, slack = adapter.force_fn(), adapter.slack_fn()

        def advance(state, x_eval_ref):
            s1 = integ.pre(state, dt, inv_m)
            return s1, max_drift(s1.x, x_eval_ref, space)

        def evaluate(arrays, state):
            """Refit, slacks and forces at state.x (spans for tracing)."""
            with _trace.span("md.refit"):
                arrays = adapter.refit(arrays, state.x)
                _trace.sync(self.device)
            with _trace.span("md.slacks"):
                slacks = slack(arrays)
                _trace.sync(self.device)
            with _trace.span("md.forces"):
                phi, f = force(arrays, state.x, q, q)
                _trace.sync(self.device)
            occ = (_occ_counters(arrays, theta=theta, space=space,
                                 skin=skin) if profile else {})
            return arrays, phi, f, slacks, occ

        def finish(arrays, state):
            arrays, phi, f, slacks, occ = evaluate(arrays, state)
            return arrays, integ.post(state, phi, f, dt, inv_m), slacks, occ

        def init_forces(arrays, state):
            arrays, phi, f, slacks, occ = evaluate(arrays, state)
            return arrays, state._replace(phi=phi, f=f), slacks, occ

        self._advance = advance
        self._finish = finish
        self._init_forces = init_forces

    def _call_logged(self, label, fn, site, *args):
        """Call one of the step's functions; log an event if it built a
        kernel library or ran on shapes it has not seen
        (`repro_torch.obs.events`)."""
        key = ("state", tuple(self.state.x.shape)) if label == "advance" \
            else self._sig
        out, _ = _events.log_compiles(
            label, fn, *args, key=key, seen=self._seen[label], site=site,
            owner=self.obs_owner)
        return out

    @property
    def compiles(self) -> int:
        """Kernel builds and first-seen shapes of the step's functions,
        from the event log."""
        return _events.log.count(owner=self.obs_owner)

    @property
    def retraces(self) -> int:
        """`compiles` beyond the ones paid by the end of step 1."""
        if self._baseline_compiles is None:
            return 0
        return max(0, self.compiles - self._baseline_compiles)

    @property
    def kernel_builds(self) -> int:
        """Kernel libraries built during this engine's calls."""
        return sum(e.get("builds", 0)
                   for e in _events.log.events(owner=self.obs_owner))

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _read_drift(self, drift_dev: torch.Tensor) -> float:
        """The step's one host sync: the drift, and in the same transfer
        the slacks of the last finish if they are still unread."""
        with _rt.explicit_sync("drift"):
            if self._slack_dev is None:
                return drift_dev.item()
            drift, ts, fs = torch.stack([drift_dev,
                                         *self._slack_dev]).tolist()
        self._theta_slack, self._fold_slack = ts, fs
        self._slack_dev = None
        return drift

    def _refresh_budgets(self) -> None:
        """Pull unread slacks onto the host (one transfer)."""
        if self._slack_dev is not None:
            with _rt.explicit_sync("budgets"):
                ts, fs = torch.stack(list(self._slack_dev)).tolist()
            self._theta_slack, self._fold_slack = ts, fs
            self._slack_dev = None

    def _drift_exceeds_budget(self, drift: float) -> bool:
        """True when the per-step drift is NOT provably within budget.

        Refit stays MAC-valid while, STRICTLY,

            2*sqrt(3)*(1 + theta) * drift < safety * theta_slack   and
            4 * drift                     < safety * fold_slack

        so this fires on ``>=`` of either. +inf slack means no safe approx
        pairs (refits are exact); a NaN slack means validity is unknown,
        and the engine falls back to the interval cadence
        (`slack_fallback` in `stats()`)."""
        ts, fs = self._theta_slack, self._fold_slack
        if math.isnan(ts) or math.isnan(fs):
            self._slack_fallback = True
            return False
        exceeded = False
        if math.isfinite(ts):
            lhs = theta_drift_rate(self._theta) * drift
            exceeded |= lhs >= self.drift_safety * ts
        if math.isfinite(fs):
            exceeded |= fold_drift_rate() * drift >= self.drift_safety * fs
        return exceeded

    def _adopt(self, invalidated: bool) -> None:
        """Take the adapter's new plan after a rebuild or a swap; a
        capacity budget that grew (new shapes) is counted (geometric
        growth bounds how often this can happen)."""
        if invalidated:
            self.capacity_growths += 1
        self.plan = self.adapter.plan
        if invalidated and self.adapter.recloses_on_rebuild:
            self._make_closures()
        self._arrays = self.adapter.arrays
        self._sig = self.adapter.signature()
        self._theta_slack = float(self.adapter.theta_slack)
        self._fold_slack = float(self.adapter.fold_slack)
        self._slack_dev = None
        self._steps_since_rebuild = 0
        self.rebuilds += 1

    def _rebuild(self, x: torch.Tensor) -> None:
        """Synchronous rebuild at `x` (wrapped), on the host or, for a
        device-built plan, on the device from `x` as it is."""
        t0 = time.perf_counter()
        self._adopt(self.adapter.rebuild(x))
        if self.adapter.device_rebuild:
            self.rebuilds_device += 1
        else:
            self.rebuilds_host += 1
        wall = (time.perf_counter() - t0) * 1e3
        self.rebuild_total_ms += wall     # blocked for all of it
        self.rebuild_wait_ms += wall

    # ------------------------------------------------------------------
    # double-buffered replan (async_replan=True)
    # ------------------------------------------------------------------

    def _dispatch_cause(self, drift: float) -> Optional[str]:
        """The rebuild cause (if any) that warrants dispatching a shadow
        build NOW, while the live plan still has budget to cover the
        in-flight window: drift at `dispatch_fraction` of either
        refreshed budget (a NaN slack never fires: the interval fallback
        owns that regime), or the interval one step before the hard
        K-step cadence."""
        ts, fs = self._theta_slack, self._fold_slack
        if not (math.isnan(ts) or math.isnan(fs)):
            frac = self.dispatch_fraction * self.drift_safety
            if math.isfinite(ts) and \
                    theta_drift_rate(self._theta) * drift >= frac * ts:
                return "drift"
            if math.isfinite(fs) and fold_drift_rate() * drift >= frac * fs:
                return "drift"
        if self._steps_since_rebuild + 1 >= self.refit_interval - 1:
            return "interval"
        return None

    def _dispatch_shadow(self, s1, cause: str) -> None:
        """Enqueue the shadow device build over the CURRENT wrapped
        positions (a separate tensor: the live trajectory keeps its
        unwrapped coordinates until the swap). Nothing here waits."""
        with _trace.span("md.rebuild_dispatch"):
            # lint: disable=ND001 — the dispatch's host ms for stats(),
            # never an input to the step
            t0 = time.perf_counter()
            self._pending = self.adapter.rebuild_dispatch(
                self.space.wrap(s1.x))
            # lint: disable=ND001 — as above
            self._pending_dispatch_ms = (time.perf_counter() - t0) * 1e3
        self._pending_cause = cause

    def _swap_plan(self, s1):
        """Commit the in-flight shadow build at a step boundary: wait for
        what is left of it, swap the live plan, and count the swap as a
        rebuild under the cause recorded at dispatch."""
        with _trace.span("plan_swap"):
            t0 = time.perf_counter()
            invalidated, wait_ms, _grew = self.adapter.rebuild_commit(
                self._pending)
            commit_ms = (time.perf_counter() - t0) * 1e3
        self._pending = None
        cause, self._pending_cause = self._pending_cause, None
        self.rebuild_wait_ms += wait_ms
        self.rebuild_total_ms += self._pending_dispatch_ms + commit_ms
        self._pending_dispatch_ms = 0.0
        self.plan_swaps += 1
        # the shadow was built over wrapped positions: re-anchor the
        # live trajectory on them (a lattice shift, as at a rebuild)
        s1 = s1._replace(x=self.space.wrap(s1.x))
        self._adopt(invalidated)
        if cause == "drift":
            self.rebuilds_drift += 1
        elif cause == "interval":
            self.rebuilds_interval += 1
        else:
            self.rebuilds_forced += 1
        self.rebuilds_device += 1
        return s1

    def step(self) -> MDState:
        """One integration step (one force evaluation)."""
        with _trace.span("md.advance"):
            s1, drift_dev = self._call_logged(
                "advance", self._advance, "Simulation.step", self.state,
                self._x_eval_ref)
            drift = self._read_drift(drift_dev)
        self._last_drift = drift

        policy = self.rebuild_policy
        cause = None
        by_drift = policy == "auto" and self._drift_exceeds_budget(drift)
        by_interval = (policy == "auto"
                       and self._steps_since_rebuild + 1
                       >= self.refit_interval)
        if self._pending is not None:
            # A shadow build is in flight: swap it in at this boundary.
            # It is newer than the live topology, so it supersedes a hard
            # trigger of this very step; the finish pass refits it to the
            # current positions, and drift since the dispatch re-fires
            # the drift trigger next step if it must.
            s1 = self._swap_plan(s1)
        elif policy == "always" or by_drift or by_interval:
            on_device = self.adapter.device_rebuild
            with _trace.span("md.rebuild_device" if on_device
                             else "md.rebuild_host"):
                # Wrap into the primary cell (a per-particle lattice
                # shift: forces and energies are minimum-image invariant).
                s1 = s1._replace(x=self.space.wrap(s1.x))
                self._rebuild(s1.x)
            # Causes PARTITION the count: drift wins ties with the
            # interval; policy "always" counts as forced.
            if by_drift:
                self.rebuilds_drift += 1
            elif by_interval:
                self.rebuilds_interval += 1
            else:
                self.rebuilds_forced += 1
        else:
            self.refits += 1
            if self.async_replan:
                cause = self._dispatch_cause(drift)

        with _trace.span("md.finish"):
            self._arrays, self.state, self._slack_dev, self._occ_dev = \
                self._call_logged("finish", self._finish, "Simulation.step",
                                  self._arrays, s1)
            _trace.sync(self.device)
        if cause is not None:
            # enqueued behind this step's forces (the reference dispatches
            # before them): the host's dispatch overlaps the card's force
            # sweep, and the shadow reads only s1.x, so nothing else moves
            self._dispatch_shadow(s1, cause)
        # The refit/refresh point is s1.x (position Verlet moves x again
        # in post; the budgets were refreshed at the force point).
        self._x_eval_ref = s1.x
        self.adapter.sync_arrays(self._arrays)
        self.steps += 1
        self._steps_since_rebuild += 1
        self.force_evals += 1
        if self._baseline_compiles is None:
            self._baseline_compiles = self.compiles
        if (self.checkpointer is not None and self.checkpoint_every
                and self.steps % self.checkpoint_every == 0):
            self.save_checkpoint()
        return self.state

    def run(self, steps: int, *, record_every: int = 0,
            callback=None) -> "Simulation":
        """Advance `steps` steps; optionally log diagnostics every
        `record_every` steps (including the starting state)."""
        if record_every and not self.log.records:
            self.log.record(self.steps, self.diagnostics())
        for _ in range(steps):
            self.step()
            if record_every and self.steps % record_every == 0:
                self.log.record(self.steps, self.diagnostics())
            if callback is not None:
                callback(self)
        return self

    # ------------------------------------------------------------------
    # diagnostics / checkpointing
    # ------------------------------------------------------------------

    def diagnostics(self) -> dict:
        """Energy / momentum / temperature at the current state, read in
        one transfer (`repro_torch.dynamics.diagnostics`). Integrators
        that leave phi/f at a midpoint get one extra force evaluation
        here so the reported energy is consistent."""
        with _trace.span("md.diagnostics"):
            if not self.integrator.phi_at_step_end and self.steps > 0:
                self._arrays, self.state, self._slack_dev, self._occ_dev \
                    = self._call_logged("init_forces", self._init_forces,
                                        "Simulation.diagnostics",
                                        self._arrays, self.state)
                self._x_eval_ref = self.state.x
                self.adapter.sync_arrays(self._arrays)
                self.force_evals += 1
            return diag.summarize(self.state, self.charges, self.masses)

    def stats(self) -> dict:
        """Engine counters and budgets (the reference's semantics):

        - ``steps``; ``refits`` (steps served by the device refit alone);
          ``rebuilds``, PARTITIONED by cause: ``rebuilds ==
          rebuilds_drift + rebuilds_interval + rebuilds_forced``
          (drift wins ties; "always" steps and checkpoint restores are
          forced), and by backend: ``rebuilds == rebuilds_host +
          devtree_rebuilds``; ``build_backend`` is the plan's.
        - ``rebuild_total_ms`` / ``rebuild_wait_ms``: rebuild wall time,
          end to end and the part the host was blocked (equal for
          synchronous rebuilds; ``async_replan`` hides the rest behind
          live steps). ``plan_swaps`` counts double-buffer swaps (each
          also a rebuild under its dispatch-time cause);
          ``pending_replan`` flags a shadow build in flight.
        - ``compiles``: kernel-library builds and first-seen plan shapes
          of the step's functions; ``retraces``: those after step 1 (0
          while every rebuild fits the budget); ``kernel_builds``:
          libraries built during the engine's calls;
          ``capacity_growths``: rebuilds that grew the budget.
        - ``theta_slack`` / ``fold_slack``: the live margins refreshed
          from the last refit's boxes; ``drift_budget_*``: the per-step
          drift each allows; ``mac_slack``: both folded into theta-rate
          units; ``last_drift``; ``slack_fallback``.
        - ``plan``: the underlying plan's own `stats()`.
        Reading it waits for the device."""
        self._refresh_budgets()
        b_theta = (self.drift_safety * self._theta_slack
                   / theta_drift_rate(self._theta))
        b_fold = self.drift_safety * self._fold_slack / fold_drift_rate()
        if math.isnan(b_theta) or math.isnan(b_fold):
            b_theta = b_fold = 0.0  # NaN slack: interval-cadence fallback
        out = dict(
            steps=self.steps,
            refits=self.refits,
            rebuilds=self.rebuilds,
            rebuilds_drift=self.rebuilds_drift,
            rebuilds_interval=self.rebuilds_interval,
            rebuilds_forced=self.rebuilds_forced,
            rebuilds_host=self.rebuilds_host,
            devtree_rebuilds=self.rebuilds_device,
            build_backend=self.plan.config.build_backend,
            retraces=self.retraces,
            compiles=self.compiles,
            kernel_builds=self.kernel_builds,
            capacity_growths=self.capacity_growths,
            async_replan=self.async_replan,
            plan_swaps=self.plan_swaps,
            pending_replan=self._pending is not None,
            rebuild_total_ms=self.rebuild_total_ms,
            rebuild_wait_ms=self.rebuild_wait_ms,
            force_evals=self.force_evals,
            refit_interval=self.refit_interval,
            rebuild_policy=self.rebuild_policy,
            integrator=self.integrator.name,
            dt=self.dt,
            space=repr(self.space),
            mac_slack=_scaled_slack(self._theta, self._theta_slack,
                                    self._fold_slack),
            theta_slack=self._theta_slack,
            fold_slack=self._fold_slack,
            skin=self._skin,
            slack_fallback=self._slack_fallback,
            last_drift=self._last_drift,
            drift_budget_theta=b_theta,
            drift_budget_fold=b_fold,
            drift_budget_skin=0.5 * self._skin,
            drift_budget=min(b_theta, b_fold),
            plan=self.plan.stats(),
        )
        if self.profile and self._occ_dev:
            keys = list(self._occ_dev)
            vals = torch.stack([self._occ_dev[k].to(torch.float64)
                                for k in keys]).tolist()
            out["occupancy"] = dict(zip(keys, vals))
        return out

    def _state_tree(self) -> dict:
        """(x, v, f, phi, key): the reference's checkpoint leaves; `key`
        holds the noise generator's state bytes."""
        s = self.state
        return dict(x=s.x, v=s.v, f=s.f, phi=s.phi, key=s.key.get_state())

    def save_checkpoint(self, background: bool = True) -> None:
        """Snapshot (x, v, f, phi, key) atomically through the configured
        `Checkpointer` (in a background thread by default)."""
        if self.checkpointer is None:
            raise ValueError("Simulation built without a checkpointer")
        self.checkpointer.save(
            self.steps, self._state_tree(),
            meta=dict(steps=self.steps, dt=self.dt,
                      integrator=self.integrator.name),
            background=background)

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Restore (x, v, f, phi, key) and re-anchor the tree at the
        restored positions (a rebuild, counted as forced).

        Checkpoints of the reference restore too: their `key` is a JAX
        PRNG key, which seeds this state's generator (the noise streams
        of the two packages differ anyway)."""
        if self.checkpointer is None:
            raise ValueError("Simulation built without a checkpointer")
        # the restored positions supersede an in-flight shadow build
        self._pending = self._pending_cause = None
        self._pending_dispatch_ms = 0.0
        like = dict(self._state_tree(), key=None)
        tree, step, _meta = self.checkpointer.restore(like, step=step)
        key = self.state.key
        saved = tree.pop("key")
        if saved.dtype.name == "uint8" and saved.size == \
                key.get_state().numel():
            key.set_state(torch.as_tensor(saved))
        else:   # a reference checkpoint: seed from its PRNG key words
            key.manual_seed(int.from_bytes(saved.tobytes(), "little")
                            % (1 << 63))
        self.state = MDState(key=key, **tree)
        self.state = self.state._replace(x=self.space.wrap(self.state.x))
        self._rebuild(self.state.x)
        self.rebuilds_forced += 1
        self._x_eval_ref = self.state.x
        self.steps = int(step)
        self._arrays, self.state, self._slack_dev, self._occ_dev = \
            self._call_logged("init_forces", self._init_forces,
                              "Simulation.restore_checkpoint",
                              self._arrays, self.state)
        self.adapter.sync_arrays(self._arrays)
        self.force_evals += 1
        return self.steps

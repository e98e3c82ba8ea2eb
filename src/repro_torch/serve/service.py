"""Shape-bucketed request service over batched ensemble plans.

Port of `repro/serve/service.py`. `ServeFrontend` accepts independent
evaluation requests (positions + charges, optional per-request kernel
params and force flag), buckets them by shape, packs each bucket into a
fixed-width `EnsemblePlan`, and flushes buckets on size or deadline,
resolving futures with per-system results.

The bucketing argument: an ensemble call's shapes are a pure function of
the `Capacities` budget and the ensemble width, and its options are the
config minus kernel-parameter VALUES (those travel as tensors). So
requests whose configs share those options and whose particle counts
quantize to the same budget share one set of shapes: the bucket key is
(stripped config, pow2-quantized N), the width is pinned to `max_batch`,
and the budget is sticky per bucket. PyTorch compiles nothing per shape;
what the service counts as a compile is an event of the ensemble
executors (`core.eval.ensemble_compile_count`: the first call on a
stacked signature, and kernel libraries built during a call). A warm
bucket therefore adds none: compiles <= buckets x executor kinds, and 0
retraces on re-submission.

    fe = ServeFrontend(TreecodeConfig(kernel="yukawa"))
    futs = [fe.submit(x_i, q_i, kernel_params={"kappa": k_i})
            for (x_i, q_i, k_i) in requests]
    phis = [f.result() for f in futs]        # forces pending flushes
    fe.stats()                               # latency/occupancy/compiles

Driving is synchronous and explicit (`submit` auto-flushes full buckets,
`poll()` flushes deadline-expired ones, `ServeFuture.result()` flushes
its own bucket), so the service is deterministic under test (inject
`clock=` for deadline tests) and needs no threads. Results come back on
the host as CPU tensors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.core import eval as _eval
from repro_torch.core.api import TreecodeConfig, resolve_device
from repro_torch.lint import runtime as _rt
from repro_torch.obs import events as _events
from repro_torch.obs import trace as _trace
from repro_torch.serve.batched import EnsemblePlan


def quantize_points(n: int, floor: int = 64) -> int:
    """A particle count rounded up to the bucket grid (next power of two,
    floored): systems of 700 and 900 points share the 1024 bucket and
    therefore one set of shapes, at bounded padding (< 2x points)."""
    m = max(int(n), 1)
    q = floor
    while q < m:
        q *= 2
    return q


def bucket_key(config: TreecodeConfig, n: int):
    """Shape bucket: the config with kernel-parameter VALUES stripped
    (they travel as tensors) + the quantized size class."""
    stripped = dataclasses.replace(config, kernel_params=())
    return (stripped, quantize_points(n))


class ServeFuture:
    """Handle for one submitted request; `result()` flushes the owning
    bucket if the request is still queued (so callers never deadlock on
    a partly filled batch)."""

    def __init__(self, frontend: "ServeFrontend", key, want_forces: bool):
        self._frontend = frontend
        self._key = key
        self.want_forces = want_forces
        self._done = False
        self._value = None
        self.latency: Optional[float] = None

    def done(self) -> bool:
        return self._done

    def _resolve(self, value, latency: float):
        self._value = value
        self.latency = latency
        self._done = True

    def result(self):
        """phi (N,), or (phi, F) when submitted with forces=True: CPU
        tensors."""
        if not self._done:
            self._frontend.flush(self._key)
        if not self._done:
            raise RuntimeError("request was not resolved by its flush")
        return self._value


class _Request:
    __slots__ = ("points", "charges", "kernel_params", "future", "t_submit")

    def __init__(self, points, charges, kernel_params, future, t_submit):
        self.points = points
        self.charges = charges
        self.kernel_params = kernel_params
        self.future = future
        self.t_submit = t_submit


class _Bucket:
    """One shape class: its queue, its sticky budget, its plan."""

    __slots__ = ("config", "queue", "capacities", "plan", "deadline",
                 "flushes", "compiles", "capacity_grows", "requests",
                 "warm_kinds")

    def __init__(self, config: TreecodeConfig):
        self.config = config
        self.queue: List[_Request] = []
        self.capacities: Optional[_eval.Capacities] = None   # sticky
        self.plan: Optional[EnsemblePlan] = None
        self.deadline: Optional[float] = None
        self.flushes = 0
        self.compiles = 0
        self.capacity_grows = 0
        self.requests = 0
        # executor kinds ("potentials" / "forces") already run on the
        # sticky budget: a compile of a warm kind IS a retrace; the first
        # forces flush after potentials-only flushes is not
        self.warm_kinds = set()


class ServeFrontend:
    """Batched treecode evaluation service (single host, synchronous).

    max_batch: the fixed ensemble width every bucket packs into (the
      occupancy/latency trade: full buckets flush at once at occupancy
      1.0; stragglers flush at the deadline, padded with dummy slots of
      zero charges to keep the shapes).
    flush_deadline: seconds a request may wait for batch-mates before
      `poll()` (or `result()`) flushes its bucket anyway.
    clock: injectable monotonic clock (tests drive deadlines by hand).
    device: where the plans run (CUDA unless ``device="cpu"``).
    """

    def __init__(self, config: TreecodeConfig = TreecodeConfig(), *,
                 max_batch: int = 8, flush_deadline: float = 0.05,
                 clock=time.monotonic, device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.debug_nans = _rt.enable_debug_nans_if_requested()
        self.config = config
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.flush_deadline = float(flush_deadline)
        self.clock = clock
        self.buckets = {}
        self.requests = 0
        self.flushes = 0
        self.compiles = 0
        self.retraces = 0
        self.capacity_grows = 0
        self.latencies: List[float] = []
        self.occupancies: List[float] = []
        # Owner token scoping this frontend's entries in the global event
        # log (repro_torch.obs.events); stats() derives its counters from
        # the log, and the attributes above are kept in lockstep.
        self.obs_owner = _events.owner_token("ServeFrontend")

    # ------------------------------------------------------------------

    def submit(self, points, charges, *, kernel_params=None,
               forces: bool = False,
               config: Optional[TreecodeConfig] = None) -> ServeFuture:
        """Enqueue one system; returns a future. Flushes the bucket as
        soon as it holds `max_batch` requests."""
        cfg = self.config if config is None else config
        points = np.asarray(points)
        charges = np.asarray(charges)
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError(f"points must be (N, 3), got {points.shape}")
        if charges.shape != (points.shape[0],):
            raise ValueError(
                f"charges must be ({points.shape[0]},), got {charges.shape}")

        with _trace.span("serve.enqueue"):
            key = bucket_key(cfg, points.shape[0])
            bucket = self.buckets.get(key)
            if bucket is None:
                bucket = self.buckets[key] = _Bucket(cfg)
            fut = ServeFuture(self, key, forces)
            bucket.queue.append(
                _Request(points, charges, kernel_params, fut, self.clock()))
            if bucket.deadline is None:
                bucket.deadline = self.clock() + self.flush_deadline
            bucket.requests += 1
            self.requests += 1
            if len(bucket.queue) >= self.max_batch:
                self._flush_bucket(key, bucket)
        return fut

    def poll(self) -> int:
        """Flush every bucket whose oldest request passed the deadline;
        returns the number of buckets flushed."""
        now = self.clock()
        n = 0
        for key, bucket in list(self.buckets.items()):
            if bucket.queue and bucket.deadline is not None \
                    and now >= bucket.deadline:
                self._flush_bucket(key, bucket)
                n += 1
        return n

    def flush(self, key=None) -> int:
        """Flush one bucket (by key) or every non-empty bucket."""
        n = 0
        for k, bucket in list(self.buckets.items()):
            if (key is None or k == key) and bucket.queue:
                self._flush_bucket(k, bucket)
                n += 1
        return n

    # ------------------------------------------------------------------

    def _flush_bucket(self, key, bucket: _Bucket) -> None:
        with _trace.span("serve.flush"):
            self._flush_bucket_impl(key, bucket)

    def _flush_bucket_impl(self, key, bucket: _Bucket) -> None:
        batch = bucket.queue[:self.max_batch]
        bucket.queue = bucket.queue[self.max_batch:]
        bucket.deadline = (None if not bucket.queue
                           else self.clock() + self.flush_deadline)

        # the host tree build packs this batch's geometry and index
        # tables and uploads them: the flush's upload site, a sanctioned
        # transfer inside a caller's no_implicit_syncs()
        with _trace.span("serve.plan_build"), \
                _rt.explicit_sync("serve_plan_build"):
            plan = EnsemblePlan.build(
                bucket.config, [r.points for r in batch],
                capacities=bucket.capacities, ensemble_width=self.max_batch,
                device=self.device)
        grew = (bucket.capacities is not None
                and plan.capacities != bucket.capacities)
        bucket.capacities = plan.capacities          # sticky budget
        if grew:
            bucket.warm_kinds.clear()                # new shapes, cold again
        bucket.plan = plan

        charges = [r.charges for r in batch]
        any_params = any(r.kernel_params is not None for r in batch)
        params = ([r.kernel_params if r.kernel_params is not None
                   else plan.kernel.params for r in batch]
                  if any_params else None)
        want_forces = any(r.future.want_forces for r in batch)
        kind = "forces" if want_forces else "potentials"
        warm = kind in bucket.warm_kinds
        bucket.warm_kinds.add(kind)

        before = _eval.ensemble_compile_count()
        t_exec = time.perf_counter()
        with _trace.span("serve.execute"):
            if want_forces:
                phi, F = plan.potential_and_forces(charges,
                                                   kernel_params=params)
            else:
                phi, F = plan.execute(charges, kernel_params=params), None
            # the flush's one wait for the device: the results go to the
            # waiting futures, and the latency recorded below includes
            # the device time
            with _rt.explicit_sync("serve_result"):
                phi = phi.cpu()
                F = F.cpu() if F is not None else None
        delta = _eval.ensemble_compile_count() - before

        self.flushes += 1
        bucket.flushes += 1
        self.compiles += delta
        bucket.compiles += delta
        if grew:
            self.capacity_grows += 1
            bucket.capacity_grows += 1
            _events.record("capacity_grow", f"ensemble_{kind}",
                           key=f"bucket(n<={key[1]})",
                           site="ServeFrontend._flush_bucket",
                           owner=self.obs_owner)
        elif delta and warm:
            # a warm bucket (no budget growth, executor kind already run)
            # paid a compile: a retrace, which must stay 0
            self.retraces += delta
        if delta:
            _events.record("compile", f"ensemble_{kind}",
                           key=f"bucket(n<={key[1]}, {kind})",
                           site="ServeFrontend._flush_bucket",
                           wall_ms=(time.perf_counter() - t_exec) * 1e3,
                           owner=self.obs_owner, count=delta,
                           retrace=bool(warm and not grew))
        self.occupancies.append(plan.occupancy)

        with _trace.span("serve.resolve"):
            now = self.clock()
            phis = plan.split(phi)
            Fs = plan.split(F) if F is not None else None
            for i, r in enumerate(batch):
                lat = now - r.t_submit
                self.latencies.append(lat)
                if r.future.want_forces:
                    r.future._resolve((phis[i], Fs[i]), lat)
                else:
                    r.future._resolve(phis[i], lat)

    # ------------------------------------------------------------------

    def queue_depth(self) -> int:
        return sum(len(b.queue) for b in self.buckets.values())

    def stats(self) -> dict:
        """Service counters, shape-consistent with `Simulation.stats()`.

        ``compiles`` / ``retraces`` / ``capacity_growths`` come from the
        event log (`repro_torch.obs.events`, scoped by this frontend's
        ``obs_owner``); ``capacity_grows`` is the reference's alias, and
        the running attributes stay in lockstep as the cross-check."""
        lat = sorted(self.latencies)

        def pct(p):
            if not lat:
                return 0.0
            return float(lat[min(len(lat) - 1,
                                 int(round(p * (len(lat) - 1))))])

        evs = _events.log.events(owner=self.obs_owner)
        compiles = sum(e["count"] for e in evs if e["kind"] == "compile")
        retraces = sum(e["count"] for e in evs
                       if e["kind"] == "compile" and e.get("retrace"))
        grows = sum(e["count"] for e in evs
                    if e["kind"] == "capacity_grow")
        return dict(
            strategy="serve",
            requests=self.requests,
            flushes=self.flushes,
            batches=self.flushes,
            queue_depth=self.queue_depth(),
            num_buckets=len(self.buckets),
            max_batch=self.max_batch,
            flush_deadline=self.flush_deadline,
            compiles=compiles,
            retraces=retraces,
            capacity_growths=grows,
            capacity_grows=grows,
            latency_p50=pct(0.50),
            latency_p99=pct(0.99),
            occupancy_mean=(float(np.mean(self.occupancies))
                            if self.occupancies else 0.0),
            buckets={repr(k): dict(requests=b.requests, flushes=b.flushes,
                                   compiles=b.compiles,
                                   capacity_grows=b.capacity_grows,
                                   queued=len(b.queue))
                     for k, b in self.buckets.items()},
        )

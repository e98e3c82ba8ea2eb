"""Public API: the treecode solver facade (port of `repro/core/api.py`).

`TreecodeSolver` is the entry point for fast summation
phi_i = sum_j G(x_i, y_j) q_j. `solver.plan(...)` builds a
`SingleDevicePlan` on the solver's device, and the plan implements

    plan.execute(charges)               -> phi          (input order)
    plan.potential_and_forces(charges)  -> (phi, F)     (input order)
    plan.stats()                        -> dict of geometry/cost counters
    plan.replan(points)                 -> new plan, same config

Typical use::

    from repro_torch.core.api import TreecodeConfig, TreecodeSolver
    solver = TreecodeSolver(TreecodeConfig(theta=0.7, degree=8))
    plan = solver.plan(points)                # targets == sources
    phi = plan.execute(charges)

The solver runs on the CUDA device unless it is given ``device="cpu"``
(where the kernels' plain PyTorch versions run); without a CUDA device
and without ``device="cpu"`` it raises rather than carry on on the CPU.

Kernel parameter sweeps reuse one plan and one CUDA binary: per-call
values are tensors on the plan's device, so no call rebuilds anything or
waits for the host::

    plan = TreecodeSolver(TreecodeConfig(kernel="yukawa")).plan(points)
    for kappa in kappas_on_device:           # 0-d tensors on the card
        phi = plan.execute(charges, kernel_params={"kappa": kappa})

`plan(..., capacities="auto")` pads the plan into a fixed budget
(`core.eval.Capacities`), and `replan` keeps it, so MD replans keep every
array shape (`repro_torch.dynamics` relies on it).

``TreecodeConfig(build_backend="device")`` builds the whole plan on the
plan's device from a Morton ordering (`repro_torch.devtree`): no host
tree, and a budgeted replan reads back only a short needs vector.
`plan.replan_async(points)` dispatches such a replan on a side CUDA
stream and returns at once; its `finalize()` swaps it in later (the MD
engine's ``async_replan``). ``precompute="hierarchical"`` takes the
internal clusters' modified charges from their children; like the
reference, it needs the host build.

Point budgets (`core.eval.Capacities.num_targets` / `num_sources`) pad
plans over different particle counts to one shape; `repro_torch.serve`
stacks such plans into ensembles that run every kernel once for all
systems.

`plan(points, nranks=P)` (P >= 2) builds a sharded plan
(`repro_torch.distributed.bltc.ShardedPlan`: RCB slabs and locally
essential trees) with all P ranks stacked on the solver's device;
`plan(points, mesh=mesh)` runs one rank per process over a 1-D
`torch.distributed` device mesh. Sharded plans are always padded into a
`core.eval.ShardedCapacities` budget.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import eval as _eval
from repro_torch.core.potentials import (Kernel, builtin_id, kernel_source,
                                         resolve_kernel)
from repro_torch.core.space import FreeSpace, PeriodicBox, resolve_space
from repro_torch.lint import runtime as _rt
from repro_torch.obs import trace as _trace
from repro_torch.obs.occupancy import static_occupancy as _static_occupancy

_BACKENDS = ("auto", "cuda", "torch")
_PRECOMPUTES = ("direct", "hierarchical")
_APPROX_R2 = ("diff", "matmul")
_DTYPES = ("auto", "float32", "float64")

@dataclasses.dataclass(frozen=True)
class TreecodeConfig:
    """BLTC parameters (Sec. 2.4 / Eq. 13 notation).

    theta: MAC parameter; degree: interpolation degree n; leaf_size: N_L;
    batch_size: N_B (0 = leaf_size, the paper's N_B == N_L). `kernel` is
    a registry name or a `Kernel`; `kernel_params` its parameters (a dict
    such as ``{"kappa": 0.7}``), the plan's defaults, overridable per
    call. `space` is `FreeSpace()` or `PeriodicBox(lengths)`. `skin` >= 0
    is the Verlet-skin radius of the dual lists (0 = frozen lists).
    `backend`: "auto" (CUDA kernels on the card, plain torch on the CPU),
    "cuda" or "torch". `kahan` compensates the slot sums; `approx_r2`
    "matmul" takes r^2 = |x|^2+|y|^2-2x.y on the approximation lane.
    `precompute`: "direct" (the paper's per-cluster modified charges) or
    "hierarchical" (the exact upward pass). `dtype` pins the working
    precision ("auto" follows the inputs). `build_backend`: "host" (the
    paper's setup phase) or "device" (`repro_torch.devtree`).
    """

    theta: float = 0.7
    degree: int = 8
    leaf_size: int = 256
    batch_size: int = 0
    kernel: Union[str, Kernel] = "coulomb"
    kernel_params: tuple = ()    # dict accepted; normalized in __post_init__
    space: object = FreeSpace()
    skin: float = 0.0
    backend: str = "auto"
    kahan: bool = False
    precompute: str = "direct"
    approx_r2: str = "diff"
    dtype: str = "auto"
    build_backend: str = "host"

    def __post_init__(self):
        def bad(msg):
            raise ValueError(f"TreecodeConfig: {msg}")

        if not (isinstance(self.theta, (int, float))
                and 0.0 < float(self.theta) <= 1.0):
            bad(f"theta must be in (0, 1], got {self.theta!r}")
        if not (isinstance(self.degree, int) and self.degree >= 1):
            bad(f"degree must be an int >= 1, got {self.degree!r}")
        if not (isinstance(self.leaf_size, int) and self.leaf_size > 0):
            bad(f"leaf_size must be > 0, got {self.leaf_size!r}")
        if not (isinstance(self.batch_size, int) and self.batch_size >= 0):
            bad(f"batch_size must be >= 0 (0 = leaf_size), "
                f"got {self.batch_size!r}")
        if not (isinstance(self.skin, (int, float))
                and float(self.skin) >= 0.0):
            bad(f"skin must be a float >= 0, got {self.skin!r}")
        object.__setattr__(self, "skin", float(self.skin))
        if self.backend not in _BACKENDS:
            bad(f"unknown backend {self.backend!r}; choose from {_BACKENDS}")
        if self.precompute not in _PRECOMPUTES:
            bad(f"unknown precompute {self.precompute!r}; "
                f"choose from {_PRECOMPUTES}")
        if self.approx_r2 not in _APPROX_R2:
            bad(f"unknown approx_r2 {self.approx_r2!r}; "
                f"choose from {_APPROX_R2}")
        if self.dtype not in _DTYPES:
            bad(f"unknown dtype {self.dtype!r}; choose from {_DTYPES}")
        if self.build_backend not in ("host", "device"):
            bad(f"unknown build_backend {self.build_backend!r}; "
                f"choose from ('host', 'device')")
        if self.build_backend == "device" \
                and self.precompute == "hierarchical":
            bad("build_backend='device' does not support "
                "precompute='hierarchical' (the upward-pass tables are "
                "host-built); use precompute='direct'")
        if not isinstance(self.kernel, (str, Kernel)):
            bad(f"kernel must be a registry name or a Kernel instance, "
                f"got {type(self.kernel).__name__}")
        kp = self.kernel_params
        if isinstance(kp, dict):
            if not all(isinstance(k, str) for k in kp):
                bad("kernel_params dict keys must be parameter names")
            kp = ("__named__",) + tuple(sorted(kp.items())) if kp else ()
            object.__setattr__(self, "kernel_params", kp)
        elif not isinstance(kp, tuple):
            bad(f"kernel_params must be a dict of named parameters or a "
                f"tuple, got {type(kp).__name__}")
        object.__setattr__(self, "space", resolve_space(self.space))

    def resolved_batch_size(self) -> int:
        return self.batch_size or self.leaf_size

    def _named_params(self) -> Optional[dict]:
        kp = self.kernel_params
        if kp and kp[0] == "__named__":
            return dict(kp[1:])
        return None

    def make_kernel(self) -> Kernel:
        named = self._named_params()
        if isinstance(self.kernel, str):
            if named is None and self.kernel_params:
                return resolve_kernel(self.kernel).with_params(
                    self.kernel_params)
            return resolve_kernel(self.kernel, **(named or {}))
        if named is not None:
            return self.kernel.with_params(named)
        if self.kernel_params:
            return self.kernel.with_params(self.kernel_params)
        return self.kernel

    def exec_opts(self, kernel: Kernel) -> dict:
        """Options consumed by `eval.execute` (the kernel stripped of its
        defaults: parameter values travel as tensors)."""
        return dict(degree=self.degree, kernel=kernel.stripped(),
                    space=self.space, backend=self.backend,
                    kahan=self.kahan, approx_r2=self.approx_r2,
                    theta=self.theta, skin=self.skin,
                    precompute=self.precompute)


def resolve_device(device=None) -> torch.device:
    """The solver's device: CUDA unless the caller asks for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device


def _resolve_dtype(config: TreecodeConfig, arr) -> torch.dtype:
    if config.dtype == "float64":
        return torch.float64
    if config.dtype == "float32":
        return torch.float32
    dt = getattr(arr, "dtype", None)
    if dt is None:
        dt = np.asarray(arr).dtype
    if dt in (np.float64, torch.float64):
        return torch.float64
    return torch.float32


def lift_params(kernel: Kernel, dtype, device) -> tuple:
    """Kernel defaults as tensors of the plan dtype on its device."""
    return tuple(torch.as_tensor(v, dtype=dtype, device=device)
                 for v in kernel.params)


def _host(points, dtype: torch.dtype) -> np.ndarray:
    """Points as a NumPy array of `dtype` (the host planner's input)."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return np.asarray(points).astype(np_dtype, copy=False)


class SingleDevicePlan:
    """Plan over the single-device pipeline (`repro_torch.core.eval`)."""

    nranks = 1

    def __init__(self, config: TreecodeConfig, kernel: Kernel,
                 inner: _eval.Plan, dtype: torch.dtype, kernel_params=None):
        self.config = config
        self.kernel = kernel
        self.inner = inner
        self.dtype = dtype
        self.device = inner.device
        # a replan hands its lifted defaults on (an upload is a sync in a
        # rebuild step); others lift the kernel's
        self.kernel_params = (lift_params(kernel, dtype, self.device)
                              if kernel_params is None else kernel_params)

    @property
    def arrays(self) -> dict:
        return self.inner.arrays

    @property
    def padding_waste(self) -> float:
        return self.inner.padding_waste

    @property
    def num_targets(self) -> int:
        return self.inner.num_targets

    @property
    def num_sources(self) -> int:
        return self.inner.num_sources

    @property
    def space(self):
        return self.config.space

    def _charges(self, charges) -> torch.Tensor:
        return torch.as_tensor(charges, dtype=self.dtype, device=self.device)

    def _params(self, kernel_params) -> tuple:
        """Per-call parameter values: None -> the plan's defaults. Dicts
        go through the kernel's `param_names`; tensor values already on
        the plan's device are used as they are."""
        if kernel_params is None:
            return self.kernel_params
        p = self.kernel.normalize_params(kernel_params)
        return tuple(torch.as_tensor(v, dtype=self.dtype, device=self.device)
                     for v in p)

    def execute(self, charges, kernel_params=None) -> torch.Tensor:
        """Potentials at the plan's targets, in input order, on the plan's
        device. `kernel_params` overrides the kernel parameter values for
        this call."""
        with _trace.span("eval.execute"):
            phi = _eval.execute(self.inner.arrays, self._charges(charges),
                                self._params(kernel_params),
                                **self.config.exec_opts(self.kernel))
            _trace.sync(self.device)
        return phi

    def potential_and_forces(self, charges, weights=None,
                             kernel_params=None):
        """(phi, F) with F_i = -w_i * grad_x phi(x_i), input order.

        One field launch per lane (`core.eval.potential_and_gradient`).
        `weights` defaults to the charges when targets == sources (the
        physical force on charge q_i); disjoint target/source sets must
        pass per-target weights explicitly."""
        q = self._charges(charges)
        if weights is None:
            if self.num_targets != self.num_sources:
                raise ValueError(
                    "potential_and_forces: targets != sources, so per-target "
                    "weights cannot default to the source charges; pass "
                    "weights= explicitly (q of each target)")
            w = q
        else:
            w = self._charges(weights)
        with _trace.span("eval.potential_and_forces"):
            out = _eval.potential_and_forces(
                self.inner.arrays, q, w, self._params(kernel_params),
                **self.config.exec_opts(self.kernel))
            _trace.sync(self.device)
        return out

    @property
    def mac_slack(self) -> float:
        return self.inner.mac_slack

    @property
    def theta_slack(self) -> float:
        return self.inner.theta_slack

    @property
    def fold_slack(self) -> float:
        return self.inner.fold_slack

    @property
    def skin(self) -> float:
        return self.inner.skin

    @property
    def capacities(self):
        """`core.eval.Capacities` when capacity-padded, else None."""
        return self.inner.capacities

    def stats(self) -> dict:
        """Geometry / cost counters: tree and batch sizes, padding waste,
        the MAC slacks, build-phase times and static occupancy. Reads
        counts off the device arrays: call it outside timed loops. A
        device-built plan reports its sizes from the needs its build
        synced (``num_nodes`` counts the hybrid octree's node rows) and
        leaves its lazy host trees unbuilt."""
        caps = self.inner.capacities
        if self.inner.build_backend == "device":
            dev = self.inner.dev
            sizes = dict(num_nodes=dev["num_nodes"],
                         num_leaves=dev["n_leaves"],
                         tree_depth=dev["depth"],
                         num_batches=dev["n_batches"])
        else:
            tree = self.inner.tree
            sizes = dict(num_nodes=tree.num_nodes,
                         num_leaves=tree.num_leaves,
                         tree_depth=int(tree.level.max()),
                         num_batches=self.inner.batches.num_batches)
        return dict(
            strategy="single_device",
            nranks=1,
            build_backend=self.inner.build_backend,
            device=str(self.device),
            num_targets=self.inner.num_targets,
            num_sources=self.inner.num_sources,
            **sizes,
            padding_waste=self.inner.padding_waste,
            dtype=str(self.dtype).replace("torch.", ""),
            space=repr(self.config.space),
            mac_slack=self.inner.mac_slack,
            theta_slack=self.inner.theta_slack,
            fold_slack=self.inner.fold_slack,
            skin=self.inner.skin,
            capacity_padded=caps is not None,
            build_phases=dict(self.inner.build_ms),
            occupancy=_static_occupancy(self.inner),
            **({"capacities": dataclasses.asdict(caps)} if caps else {}),
        )

    def replan(self, targets, sources=None, *,
               capacities="keep") -> "SingleDevicePlan":
        """Rebuild geometry for moved particles under the same config, on
        the same device.

        `capacities="keep"` (default) re-pads into this plan's own budget
        when it has one, growing it geometrically if the new geometry no
        longer fits; None drops the padding; "auto" or a
        `core.eval.Capacities` pads into that. A device-built plan's
        replan keeps its octree depths and traversal budgets with the
        capacities (the budget is bound to the depths)."""
        if capacities == "keep":
            capacities = self.inner.capacities
        dev = self.inner.dev or {}
        keep = capacities is not None
        return _plan_single(self.config, self.kernel, targets,
                            targets if sources is None else sources,
                            self.device, capacities,
                            pair_caps=dev.get("pair_caps"),
                            depth=dev.get("depth") if keep else None,
                            batch_depth=dev.get("tdepth") if keep else None,
                            kernel_params=self.kernel_params)

    def replan_async(self, targets,
                     sources=None) -> "PendingSingleDevicePlan":
        """Dispatch a shadow replan without blocking (device builds only).

        Enqueues the whole sort/build/list pipeline at this plan's budget
        (on a side CUDA stream that first waits for the current one) and
        returns at once; this plan stays live and untouched. `finalize()`
        on the returned handle waits for what is left and gives the new
        plan: the double-buffered rebuild the MD engine swaps in at a
        step boundary. `targets` should already be a tensor on the
        plan's device: an upload from the host would wait for it."""
        if self.inner.build_backend != "device":
            raise ValueError(
                "replan_async requires build_backend='device' (host "
                "builds run on the host thread and cannot overlap)")
        if self.inner.capacities is None:
            raise ValueError(
                "replan_async requires a capacity-padded plan (the async "
                "path never probes budgets)")
        from repro_torch.devtree import build as _devbuild
        dev = self.inner.dev
        xt, xs = _on_device(targets, sources, self.dtype, self.device)
        pending = _devbuild.dispatch_plan_device(
            xt, xs, theta=self.config.theta, degree=self.config.degree,
            leaf_size=self.config.leaf_size,
            batch_size=self.config.resolved_batch_size(),
            space=self.config.space, skin=self.config.skin,
            capacities=self.inner.capacities, pair_caps=dev["pair_caps"],
            depth=dev["depth"], batch_depth=dev["tdepth"])
        return PendingSingleDevicePlan(self, pending)


class PendingSingleDevicePlan:
    """An in-flight `SingleDevicePlan.replan_async`.

    `finalize()` waits for the shadow build and returns ``(plan,
    wait_ms, grew)``: the new `SingleDevicePlan`, the milliseconds the
    host spent waiting, and whether the budget grew (the handle then
    rebuilt at the grown budget, blocking: the synchronous path's
    `capacity_growth` contract)."""

    def __init__(self, source: SingleDevicePlan, pending):
        self._source = source
        self._pending = pending

    def finalize(self):
        inner, wait_ms, grew = self._pending.finalize()
        s = self._source
        return (SingleDevicePlan(s.config, s.kernel, inner, s.dtype,
                                 s.kernel_params), wait_ms, grew)


def _on_device(targets, sources, dtype: torch.dtype, device: torch.device):
    """Targets and sources as tensors of `dtype` on `device` (sources that
    are the targets stay the same tensor: one sort serves both trees)."""
    xt = torch.as_tensor(targets, dtype=dtype, device=device)
    xs = xt if sources is None or sources is targets else torch.as_tensor(
        sources, dtype=dtype, device=device)
    return xt, xs


def _plan_single(config: TreecodeConfig, kernel: Kernel, targets, sources,
                 device: torch.device, capacities=None, pair_caps=None,
                 depth=None, batch_depth=None,
                 kernel_params=None) -> SingleDevicePlan:
    if isinstance(capacities, str) and capacities != "auto":
        raise ValueError(f"capacities must be None, 'auto', 'keep' or a "
                         f"Capacities, got {capacities!r}")
    if not isinstance(capacities, (type(None), str, _eval.Capacities)):
        raise TypeError(
            f"single-device capacities must be None, 'auto', 'keep' or a "
            f"core.eval.Capacities, got {type(capacities).__name__} (a "
            f"ShardedCapacities budgets sharded plans: pass nranks=)")
    dtype = _resolve_dtype(config, targets)
    if config.build_backend == "device":
        # positions stay on the device, and the plan comes back padded
        # into its capacities (probed on a first build)
        from repro_torch.devtree import build as _devbuild
        xt, xs = _on_device(targets, sources, dtype, device)
        inner = _devbuild.prepare_plan_device(
            xt, xs, theta=config.theta, degree=config.degree,
            leaf_size=config.leaf_size,
            batch_size=config.resolved_batch_size(), space=config.space,
            skin=config.skin,
            capacities=None if capacities == "auto" else capacities,
            pair_caps=pair_caps, depth=depth, batch_depth=batch_depth)
        return SingleDevicePlan(config, kernel, inner, dtype, kernel_params)
    # the host planner pulls the points and uploads the plan: a
    # sanctioned transfer inside a caller's no_implicit_syncs()
    with _rt.explicit_sync("host_build"):
        inner = _eval.prepare_plan(
            _host(targets, dtype), _host(sources, dtype),
            theta=config.theta, degree=config.degree,
            leaf_size=config.leaf_size,
            batch_size=config.resolved_batch_size(), space=config.space,
            skin=config.skin, device=device)
        if config.precompute == "hierarchical":
            inner = _eval.add_hierarchical_tables(inner)
        if capacities is not None:
            capacities = (_eval.Capacities.for_plan(inner)
                          if capacities == "auto"
                          else capacities.grown_to_fit(inner))
            inner = _eval.pad_plan(inner, capacities)
    return SingleDevicePlan(config, kernel, inner, dtype, kernel_params)


class TreecodeSolver:
    """Fast summation phi_i = sum_j G(x_i, y_j) q_j in O(N log N).

    `device` defaults to CUDA; pass ``device="cpu"`` for the plain
    PyTorch path. On CUDA any kernel runs through the hand-written
    kernels: Coulomb and Yukawa on their hand-tuned paths, a user kernel
    (`register_kernel`, `Kernel(...)`) through its user library, whose G
    and 2 G' are generated from its torch `of_r2` and built at first use
    (`kernels.codegen`). A kernel the generator does not take raises
    NotImplementedError when the solver is built, naming what it met;
    ``backend="torch"`` takes any kernel."""

    def __init__(self, config: TreecodeConfig = TreecodeConfig(),
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self._kernel = config.make_kernel()
        if (self.device.type == "cuda" and config.backend != "torch"
                and builtin_id(self._kernel) is None):
            kernel_source(self._kernel)      # the generator's refusal, now

    @property
    def kernel(self) -> Kernel:
        return self._kernel

    @property
    def space(self):
        return self.config.space

    def plan(self, targets, sources=None, *, mesh=None,
             nranks: Optional[int] = None, capacities=None):
        """Build an execution plan for this geometry (sources default to
        the targets, the N-body setting).

        Strategy: an explicit `mesh` (a 1-D `torch.distributed` device
        mesh, one rank per process) or `nranks` wins; otherwise P is the
        world size when `torch.distributed` is initialised and the
        targets are the sources, else 1, and it drops to 1 when there
        are fewer points than ranks. P >= 2 builds a sharded plan, which
        requires targets == sources; ``nranks=P`` stacks the P ranks on
        the solver's device.

        `capacities`: single-device plans take None (no padding), "auto"
        or a `core.eval.Capacities` (shape-stable replans, the MD
        setting); sharded plans are always padded, into a budget of
        their own needs (None / "auto") or a
        `core.eval.ShardedCapacities`."""
        same = sources is None or sources is targets
        if mesh is not None and nranks is not None:
            raise ValueError("pass either mesh= or nranks=, not both")
        if mesh is not None:
            if mesh.ndim != 1:
                raise ValueError(
                    f"sharded plans shard over exactly one mesh dimension; "
                    f"got {mesh.ndim}")
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"mesh of {mesh.device_type!r} devices for a solver on "
                    f"{self.device}")
            p = mesh.size()
        elif nranks is not None:
            p = int(nranks)
            if p < 1:
                raise ValueError(f"nranks must be >= 1, got {nranks}")
        else:
            # clamped to what the geometry can feed: RCB needs at least
            # one particle per rank
            dist = torch.distributed
            p = (dist.get_world_size() if same and dist.is_available()
                 and dist.is_initialized() else 1)
            if len(targets) < p:
                p = 1
        if p == 1:
            return _plan_single(self.config, self._kernel, targets,
                                targets if sources is None else sources,
                                self.device, capacities)
        if not same:
            raise ValueError(
                "sharded planning (nranks >= 2) requires targets == sources; "
                "pass nranks=1 for disjoint target/source sets")
        from repro_torch.distributed.bltc import ShardedPlan
        from repro_torch.distributed.exchange import GroupRanks, StackedRanks
        ranks = GroupRanks(mesh) if mesh is not None else StackedRanks(p)
        points = _host(targets, _resolve_dtype(self.config, targets))
        return ShardedPlan.build(points, self.config, p, ranks=ranks,
                                 device=self.device, kernel=self._kernel,
                                 capacities=("auto" if capacities is None
                                             else capacities))

    def execute(self, plan: SingleDevicePlan, charges) -> torch.Tensor:
        return plan.execute(charges)

    def potential_and_forces(self, plan: SingleDevicePlan, charges,
                             weights=None):
        return plan.potential_and_forces(charges, weights)

    def __call__(self, targets, sources, charges) -> torch.Tensor:
        return self.plan(targets, sources).execute(charges)


__all__ = ["TreecodeConfig", "TreecodeSolver", "SingleDevicePlan",
           "PendingSingleDevicePlan", "FreeSpace", "PeriodicBox",
           "resolve_device"]

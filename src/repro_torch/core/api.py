"""Public API: the treecode solver facade (port of `repro/core/api.py`).

`TreecodeSolver` is the entry point for fast summation
phi_i = sum_j G(x_i, y_j) q_j. `solver.plan(...)` builds a
`SingleDevicePlan` on the solver's device, and the plan implements

    plan.execute(charges)  -> phi          (input order)
    plan.stats()           -> dict of geometry/cost counters
    plan.replan(points)    -> new plan, same config

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

Not in this slice (each raises NotImplementedError naming its ROADMAP
item): forces (`potential_and_forces`), the hierarchical precompute,
the device tree build, capacity padding and sharded plans (nranks > 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import eval as _eval
from repro_torch.core.potentials import Kernel, builtin_id, resolve_kernel
from repro_torch.core.space import FreeSpace, PeriodicBox, resolve_space
from repro_torch.obs import trace as _trace
from repro_torch.obs.occupancy import static_occupancy as _static_occupancy

_BACKENDS = ("auto", "cuda", "torch")
_PRECOMPUTES = ("direct", "hierarchical")
_APPROX_R2 = ("diff", "matmul")
_DTYPES = ("auto", "float32", "float64")

_LATER = {
    "hierarchical": "precompute='hierarchical' is not ported yet "
                    "(ROADMAP queue A: hierarchical precompute)",
    "device": "build_backend='device' is not ported yet "
              "(ROADMAP queue A: device tree build)",
    "capacities": "capacities= is not ported yet "
                  "(ROADMAP queue A: capacities and pad_plan)",
    "nranks": "sharded plans (nranks > 1) are not ported yet "
              "(ROADMAP queue A: sharded)",
    "forces": "potential_and_forces is not ported yet "
              "(ROADMAP queue A: forces with a CUDA field kernel)",
}


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
    `dtype` pins the working precision ("auto" follows the inputs).
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
        if self.precompute == "hierarchical":
            raise NotImplementedError(_LATER["hierarchical"])
        if self.build_backend == "device":
            raise NotImplementedError(_LATER["device"])

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
                    theta=self.theta, skin=self.skin)


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
                 inner: _eval.Plan, dtype: torch.dtype):
        self.config = config
        self.kernel = kernel
        self.inner = inner
        self.dtype = dtype
        self.device = inner.device
        self.kernel_params = lift_params(kernel, dtype, self.device)

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
        raise NotImplementedError(_LATER["forces"])

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

    def stats(self) -> dict:
        """Geometry / cost counters: tree and batch sizes, padding waste,
        the MAC slacks, build-phase times and static occupancy. Reads
        counts off the device arrays: call it outside timed loops."""
        tree = self.inner.tree
        return dict(
            strategy="single_device",
            nranks=1,
            build_backend="host",
            device=str(self.device),
            num_targets=self.inner.num_targets,
            num_sources=self.inner.num_sources,
            num_nodes=tree.num_nodes,
            num_leaves=tree.num_leaves,
            tree_depth=int(tree.level.max()),
            num_batches=self.inner.batches.num_batches,
            padding_waste=self.inner.padding_waste,
            dtype=str(self.dtype).replace("torch.", ""),
            space=repr(self.config.space),
            mac_slack=self.inner.mac_slack,
            theta_slack=self.inner.theta_slack,
            fold_slack=self.inner.fold_slack,
            skin=self.inner.skin,
            capacity_padded=False,
            build_phases=dict(self.inner.build_ms),
            occupancy=_static_occupancy(self.inner),
        )

    def replan(self, targets, sources=None, *,
               capacities=None) -> "SingleDevicePlan":
        """Rebuild geometry for moved particles under the same config, on
        the same device."""
        if capacities is not None:
            raise NotImplementedError(_LATER["capacities"])
        return _plan_single(self.config, self.kernel, targets,
                            targets if sources is None else sources,
                            self.device)


def _plan_single(config: TreecodeConfig, kernel: Kernel, targets, sources,
                 device: torch.device) -> SingleDevicePlan:
    dtype = _resolve_dtype(config, targets)
    inner = _eval.prepare_plan(
        _host(targets, dtype), _host(sources, dtype),
        theta=config.theta, degree=config.degree,
        leaf_size=config.leaf_size, batch_size=config.resolved_batch_size(),
        space=config.space, skin=config.skin, device=device)
    return SingleDevicePlan(config, kernel, inner, dtype)


class TreecodeSolver:
    """Fast summation phi_i = sum_j G(x_i, y_j) q_j in O(N log N).

    `device` defaults to CUDA; pass ``device="cpu"`` for the plain
    PyTorch path. A user-registered kernel runs only on
    ``backend="torch"`` (the CUDA kernel knows Coulomb and Yukawa)."""

    def __init__(self, config: TreecodeConfig = TreecodeConfig(),
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self._kernel = config.make_kernel()
        if (self.device.type == "cuda" and config.backend != "torch"
                and builtin_id(self._kernel) is None):
            raise NotImplementedError(
                f"kernel {self._kernel.name!r} has no CUDA kernel; use "
                f"backend='torch' (user kernels on CUDA: ROADMAP queue B)")

    @property
    def kernel(self) -> Kernel:
        return self._kernel

    @property
    def space(self):
        return self.config.space

    def plan(self, targets, sources=None, *, nranks: Optional[int] = None,
             capacities=None) -> SingleDevicePlan:
        """Build an execution plan for this geometry (sources default to
        the targets, the N-body setting)."""
        if nranks is not None and int(nranks) != 1:
            raise NotImplementedError(_LATER["nranks"])
        if capacities is not None:
            raise NotImplementedError(_LATER["capacities"])
        return _plan_single(self.config, self._kernel, targets,
                            targets if sources is None else sources,
                            self.device)

    def execute(self, plan: SingleDevicePlan, charges) -> torch.Tensor:
        return plan.execute(charges)

    def __call__(self, targets, sources, charges) -> torch.Tensor:
        return self.plan(targets, sources).execute(charges)


__all__ = ["TreecodeConfig", "TreecodeSolver", "SingleDevicePlan",
           "FreeSpace", "PeriodicBox", "resolve_device"]

"""Interaction kernels G(x, y) (Eq. 2) in a kernel-independent registry.

PyTorch port of `repro/core/potentials.py`. The BLTC only ever
*evaluates* G, as a function of the squared distance plus parameters.
Self-interaction and padded-slot contributions are removed by the
``r2 > 0`` mask, matching the treecode convention of excluding the
singular i == j term.

Kernel parameters:

  - `of_r2(r2, params)` is a torch function; `params` is a tuple whose
    leaves may be Python floats (the hashable defaults) or tensors on
    the plan's device (the per-call values). Passing tensors is what
    lets a Yukawa `kappa` sweep reuse one plan and one compiled CUDA
    binary without a host sync.
  - `params` on the Kernel holds hashable DEFAULTS; `param_names`
    optionally names the entries so user APIs accept ``{"kappa": 0.7}``.
  - `pack_params` flattens a params tuple into ONE flat tensor on the
    target device: the CUDA batch-cluster kernel reads its parameters
    through that device pointer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.space import FREE as _FREE


def _leaves(tree):
    """Flatten a (nested) tuple/list params tree into its leaves."""
    if isinstance(tree, (tuple, list)):
        out = []
        for t in tree:
            out.extend(_leaves(t))
        return out
    return [tree]


def _hashable(tree):
    """Normalize a params tree into a hashable default (tuples, floats)."""
    if isinstance(tree, dict):
        raise TypeError("use param_names + a tuple for named defaults "
                        "(dict params are accepted by with_params)")
    if isinstance(tree, (tuple, list)):
        return tuple(_hashable(t) for t in tree)
    if isinstance(tree, torch.Tensor):
        return float(tree) if tree.dim() == 0 \
            else tuple(float(v) for v in tree.reshape(-1))
    return float(tree)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A smooth, non-oscillatory interaction kernel.

    Attributes:
      name: registry name.
      of_r2: (r2, params) -> G, a torch function; must be finite for
        r2 > 0. Values at r2 == 0 are ignored (masked by callers).
      params: hashable default parameters (e.g. Yukawa kappa).
      param_names: optional names aligned with a tuple `params`.
    """

    name: str
    of_r2: Callable
    params: tuple = ()
    param_names: tuple = ()

    def __call__(self, r2: torch.Tensor, params=None) -> torch.Tensor:
        """Masked evaluation: G(r) for r2 > 0, exactly 0 at r2 == 0."""
        if params is None:
            params = self.params
        pos = r2 > 0.0
        safe = torch.where(pos, r2, torch.ones_like(r2))
        return torch.where(pos, self.of_r2(safe, params),
                           torch.zeros_like(r2))

    def normalize_params(self, params):
        """Dict params -> the tuple structure `of_r2` expects."""
        if params is None:
            return self.params
        if isinstance(params, dict):
            if not self.param_names:
                raise ValueError(
                    f"kernel {self.name!r} declares no param_names; pass "
                    f"params with the tuple structure of_r2 expects")
            unknown = set(params) - set(self.param_names)
            if unknown:
                raise ValueError(
                    f"kernel {self.name!r} has no parameter(s) "
                    f"{sorted(unknown)}; have {list(self.param_names)}")
            defaults = dict(zip(self.param_names, self.params))
            defaults.update(params)
            return tuple(defaults[k] for k in self.param_names)
        return params

    def with_params(self, params) -> "Kernel":
        """New kernel with different hashable defaults (dict or tuple)."""
        return dataclasses.replace(
            self, params=_hashable(self.normalize_params(params)))

    def stripped(self) -> "Kernel":
        """Default-free copy (two kernels differing only in default
        params compare equal once stripped)."""
        if not self.params:
            return self
        return dataclasses.replace(self, params=())

    def pairwise(self, x: torch.Tensor, y: torch.Tensor, params=None,
                 space=_FREE) -> torch.Tensor:
        """G(x_i, y_j) for x (..., nx, 3), y (..., ny, 3) -> (..., nx, ny).

        Displacements come from `space` (minimum-image under a
        `PeriodicBox`)."""
        d = space.displacement(x[..., :, None, :], y[..., None, :, :])
        return self((d * d).sum(-1), params)

    def pairwise_matmul(self, x: torch.Tensor, y: torch.Tensor, params=None,
                        space=_FREE) -> torch.Tensor:
        """G via r^2 = |x|^2 + |y|^2 - 2 x.y (the cross term as a K = 3
        contraction). Safe for MAC-separated target/cluster pairs only;
        periodic spaces fall back to the difference form."""
        if getattr(space, "periodic", False):
            return self.pairwise(x, y, params, space)
        xy = torch.einsum("...nd,...md->...nm", x, y)
        x2 = (x * x).sum(-1)[..., :, None]
        y2 = (y * y).sum(-1)[..., None, :]
        return self(torch.clamp(x2 + y2 - 2.0 * xy, min=0.0), params)


def _coulomb(r2, params):
    del params
    return torch.reciprocal(torch.sqrt(r2))


def _yukawa(r2, params):
    (kappa,) = params
    r = torch.sqrt(r2)
    return torch.exp(-kappa * r) / r


def coulomb() -> Kernel:
    """G(x,y) = 1/|x-y| (Eq. 2, left)."""
    return Kernel("coulomb", _coulomb)


def yukawa(kappa: float = 0.5) -> Kernel:
    """G(x,y) = exp(-kappa |x-y|)/|x-y| (Eq. 2, right)."""
    return Kernel("yukawa", _yukawa, (float(kappa),), ("kappa",))


#: Kernel functions the CUDA batch-cluster kernel implements, by the id
#: its template takes. A user kernel runs on the "torch" backend only.
BUILTIN_IDS = {_coulomb: 0, _yukawa: 1}

_REGISTRY = {"coulomb": coulomb, "yukawa": yukawa}


def builtin_id(kernel: Kernel):
    """The CUDA kernel id of a built-in kernel, None for user kernels."""
    return BUILTIN_IDS.get(kernel.of_r2)


def register_kernel(name: str, factory: Callable[..., Kernel],
                    overwrite: bool = False) -> None:
    """Register a user kernel factory under `name`.

    The factory is called as ``factory(**params)`` and must return a
    `Kernel` whose `of_r2` is a torch function."""
    if name in _REGISTRY and not overwrite:
        raise KeyError(f"kernel {name!r} already registered "
                       "(pass overwrite=True to replace)")
    _REGISTRY[name] = factory


def registered_kernels() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_kernel(name: str, **params) -> Kernel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(_REGISTRY)}")
    kern = _REGISTRY[name](**params)
    if not isinstance(kern, Kernel):
        raise TypeError(f"kernel factory {name!r} returned "
                        f"{type(kern).__name__}, expected Kernel")
    return kern


def resolve_kernel(kernel, **params) -> Kernel:
    """Accept either a registry name or a ready `Kernel` instance."""
    if isinstance(kernel, Kernel):
        if params:
            return kernel.with_params(params)
        return kernel
    if isinstance(kernel, str):
        return get_kernel(kernel, **params)
    raise TypeError(f"kernel must be a name or Kernel, got "
                    f"{type(kernel).__name__}")


def pack_params(params, *, dtype, device) -> torch.Tensor:
    """Flatten a params tree into one flat (max(P, 1),) tensor.

    Tensor leaves already on `device` are concatenated there (no host
    round trip); Python floats are uploaded. An empty tree packs to one
    zero so the kernel signature is uniform."""
    leaves = _leaves(params)
    if not leaves:
        return torch.zeros(1, dtype=dtype, device=device)
    return torch.cat([torch.as_tensor(v, dtype=dtype, device=device)
                      .reshape(-1) for v in leaves])

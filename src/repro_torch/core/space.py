"""First-class geometry: the space the kernel G(x, y) lives in.

PyTorch port of `repro/core/space.py`. Every pairwise path consumes a
displacement x - y, and only the `Space` decides what that displacement
is:

  - `FreeSpace`: the paper's setting. Displacements are plain Euclidean
    differences; `wrap` is the identity.
  - `PeriodicBox`: an orthorhombic box with the minimum-image convention.
    Displacements are folded into [-L/2, L/2] per coordinate
    (d - L * round(d / L)), and `wrap` maps coordinates into
    [origin, origin + L).

Spaces are frozen dataclasses (hashable), so plans and kernel wrappers
can key caches on them.

All methods accept NumPy arrays (the host tree/traversal phase, which
must stay bitwise equal to the reference planner) and torch tensors (the
device pipeline); the namespace is dispatched on the input type. The
torch branch rounds with `torch.round` (half to even, as `np.round` and
`jnp.round`) and wraps with `torch.remainder` (floor-mod, as Python's
``%``; `torch.fmod` truncates and would map negatives outside the cell).

Correctness note for the treecode under `PeriodicBox` (DESIGN.md §5): a
batch-cluster pair is approximated only when it is *fold-free*
(`fold_margin` > 0), so min_image is one rigid shift of the cluster and
the free-space interpolation error theory applies.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _device_consts(values: tuple, dtype, device) -> torch.Tensor:
    # cached: an upload to the card waits for its stream
    return torch.tensor(values, dtype=dtype, device=device)


def _xp(a):
    """NumPy for host arrays, torch for tensors."""
    return torch if isinstance(a, torch.Tensor) else np


def _consts(values, like):
    """`values` as an array of `like`'s kind, dtype and device."""
    if isinstance(like, torch.Tensor):
        return _device_consts(tuple(values), like.dtype, like.device)
    return np.asarray(values, dtype=like.dtype)


@dataclasses.dataclass(frozen=True)
class FreeSpace:
    """Unbounded Euclidean R^3 (the paper's setting)."""

    periodic = False

    def wrap(self, x):
        """Canonical coordinates: the identity in free space."""
        return x

    def min_image(self, d):
        """Displacement convention: plain difference in free space."""
        return d

    def displacement(self, x, y):
        """x - y under this space's convention (broadcasts)."""
        return x - y

    def fold_margin(self, d_center, spread):
        """Smoothness margin of a batch-cluster pair (+inf: no folds)."""
        del d_center, spread
        return np.inf


@dataclasses.dataclass(frozen=True)
class PeriodicBox:
    """Orthorhombic periodic box with the minimum-image convention.

    Attributes:
      lengths: (Lx, Ly, Lz) box edge lengths, all > 0.
      origin: lower corner of the primary cell; `wrap` maps coordinates
        into [origin, origin + lengths) per dimension.
    """

    lengths: tuple
    origin: tuple = (0.0, 0.0, 0.0)

    periodic = True

    def __post_init__(self):
        L = tuple(float(v) for v in np.ravel(np.asarray(self.lengths)))
        if len(L) == 1:
            L = L * 3
        if len(L) != 3 or any(v <= 0 for v in L):
            raise ValueError(
                f"PeriodicBox lengths must be 3 positive extents (or one "
                f"cubic extent), got {self.lengths!r}")
        o = tuple(float(v) for v in np.ravel(np.asarray(self.origin)))
        if len(o) != 3:
            raise ValueError(f"PeriodicBox origin must have 3 components, "
                             f"got {self.origin!r}")
        object.__setattr__(self, "lengths", L)
        object.__setattr__(self, "origin", o)

    def wrap(self, x):
        """Map coordinates into the primary cell [origin, origin + L)."""
        L = _consts(self.lengths, x)
        o = _consts(self.origin, x)
        return o + _xp(x).remainder(x - o, L)  # floor-mod, never fmod

    def min_image(self, d):
        """Fold displacements into [-L/2, L/2] per coordinate.

        Exact for ANY real input, unwrapped positions included."""
        L = _consts(self.lengths, d)
        return d - L * _xp(d).round(d / L)  # half to even in both

    def displacement(self, x, y):
        """Minimum-image x - y (broadcasts)."""
        return self.min_image(x - y)

    def fold_margin(self, d_center, spread):
        """How far a batch-cluster pair is from a minimum-image fold.

        Args:
          d_center: (..., 3) center-to-center displacement (pre-fold).
          spread: (..., 3) or scalar per-coordinate bound on the deviation
            of any target-source displacement in the pair from
            `d_center`.

        Returns:
          (...) min over dimensions of L_d/2 - |min_image(d_center)_d|
          - spread_d. Positive means every pairwise displacement in the
          pair folds with the SAME image shift.
        """
        xp = _xp(d_center)
        L = _consts(self.lengths, d_center)
        folded = xp.abs(self.min_image(d_center))
        return xp.amin(L / 2.0 - folded - spread, -1)


#: Shared free-space singleton: THE default `space=` everywhere.
FREE = FreeSpace()


def resolve_space(space) -> "FreeSpace | PeriodicBox":
    """Accept a Space instance or None (free space).

    Duck-typed third-party spaces must provide the full protocol the
    executors consume: the four methods, a boolean `periodic` flag and,
    for periodic spaces, the 3 per-axis `lengths` the kernels fold with.
    """
    if space is None:
        return FREE
    if isinstance(space, (FreeSpace, PeriodicBox)):
        return space
    for attr in ("wrap", "min_image", "displacement", "fold_margin"):
        if not callable(getattr(space, attr, None)):
            raise TypeError(
                f"space must be FreeSpace, PeriodicBox or provide "
                f"wrap/min_image/displacement/fold_margin; got "
                f"{type(space).__name__} (missing {attr})")
    periodic = getattr(space, "periodic", None)
    if not isinstance(periodic, bool):
        raise TypeError(
            f"space {type(space).__name__} must define a boolean "
            f"`periodic` attribute (the kernel paths dispatch on it)")
    if periodic and len(getattr(space, "lengths", ())) != 3:
        raise TypeError(
            f"periodic space {type(space).__name__} must expose 3 "
            f"`lengths` (per-axis box extents) for the kernel fold")
    return space

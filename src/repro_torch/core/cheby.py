"""Barycentric Lagrange interpolation at Chebyshev points of the 2nd kind.

PyTorch port of `repro/core/cheby.py` (Sec. 2.1-2.3 of Vaughn, Wilson &
Krasny, 2020):
  - Chebyshev points of the 2nd kind s_k = cos(pi k / n)  (Eq. 6)
  - barycentric weights w_k = (-1)^k delta_k               (Eq. 7)
  - barycentric rows w_k / (y - s_k) with exact-hit (removable-singularity)
    handling (Sec. 2.3).

Points and weights are computed in NumPy float64 and then cast, exactly
as the reference does, so both packages start from bit-identical nodes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


# The constants are cached per (n, dtype, device): an upload from host
# memory to the card waits for the stream, and `execute` needs them on
# every call. Callers must not write into the returned tensors.
@functools.lru_cache(maxsize=None)
def _cached(kind: str, n: int, dtype, device) -> torch.Tensor:
    if kind == "points":
        k = np.arange(n + 1)
        vals = np.cos(np.pi * k / n)
    else:
        vals = np.power(-1.0, np.arange(n + 1))
        vals[0] *= 0.5
        vals[-1] *= 0.5
    return torch.as_tensor(vals, dtype=dtype, device=device)


def cheb_points_1d(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Chebyshev points of the 2nd kind on [-1, 1], k = 0..n (n+1 points).

    Returned in the natural ordering s_0 = 1 ... s_n = -1 (Eq. 6).
    """
    return _cached("points", n, dtype, torch.device(device or "cpu"))


def bary_weights_1d(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Barycentric weights for 2nd-kind Chebyshev points (Eq. 7):
    w_k = (-1)^k * delta_k with delta_k = 1/2 at the endpoints."""
    return _cached("weights", n, dtype, torch.device(device or "cpu"))


def map_points(s: torch.Tensor, lo, hi) -> torch.Tensor:
    """Linearly map 2nd-kind points from [-1,1] to [lo, hi] (broadcasts).

    Same operation order as the reference, so mapped nodes match it
    bitwise on the same inputs."""
    return lo + (hi - lo) * (s + 1.0) * 0.5


def cluster_grid(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Tensor-product Chebyshev grid for a cluster box.

    Args:
      lo, hi: (..., 3) cluster bounding box corners.
      n: interpolation degree (n+1 points per dimension).

    Returns:
      (..., (n+1)**3, 3) grid points, ordered with k3 fastest.
    """
    s = cheb_points_1d(n, lo.dtype, lo.device)
    s1 = map_points(s, lo[..., 0:1], hi[..., 0:1])
    s2 = map_points(s, lo[..., 1:2], hi[..., 1:2])
    s3 = map_points(s, lo[..., 2:3], hi[..., 2:3])
    m = n + 1
    shape = s1.shape[:-1] + (m, m, m)
    g1 = s1[..., :, None, None].expand(shape)
    g2 = s2[..., None, :, None].expand(shape)
    g3 = s3[..., None, None, :].expand(shape)
    grid = torch.stack([g1, g2, g3], dim=-1)  # (..., m, m, m, 3)
    return grid.reshape(grid.shape[:-4] + (m * m * m, 3))


def bary_terms(y: torch.Tensor, s: torch.Tensor, w: torch.Tensor, tol=0.0):
    """Barycentric terms t_k = w_k / (y - s_k) with exact-hit handling.

    Args:
      y: (...,) evaluation coordinates.
      s: (m,) (or broadcastable) interpolation nodes, already mapped.
      w: (m,) barycentric weights.
      tol: hit tolerance; the default 0.0 is the paper's Sec. 2.3
        convention (exact equality). A positive float or a tensor
        switches to ``|y - s| <= tol``.

    Returns:
      (terms, denom): terms (..., m) and denom (...,) = sum_k terms, such
      that L_k(y) = terms[..., k] / denom. On a hit, terms is the one-hot
      row and denom is 1.
    """
    d = y[..., None] - s
    if isinstance(tol, torch.Tensor) or tol > 0.0:
        hit = d.abs() <= tol
    else:
        hit = d == 0.0
    any_hit = hit.any(dim=-1, keepdim=True)
    safe_d = torch.where(hit, torch.ones_like(d), d)
    t = w / safe_d
    t = torch.where(any_hit, hit.to(y.dtype), t)
    denom = t.sum(dim=-1)
    return t, denom


def lagrange_rows(y: torch.Tensor, s: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """L_k(y) for all k: (..., m) rows that sum to 1 (barycentric form)."""
    t, denom = bary_terms(y, s, w)
    return t / denom[..., None]


def interp_1d(fvals: torch.Tensor, y: torch.Tensor, n: int) -> torch.Tensor:
    """Barycentric interpolation of f sampled at 2nd-kind points on [-1,1].

    Test/diagnostic helper: p_n(y) for f given by fvals at cheb_points_1d(n).
    """
    s = cheb_points_1d(n, fvals.dtype, fvals.device)
    w = bary_weights_1d(n, fvals.dtype, fvals.device)
    return lagrange_rows(y, s, w) @ fvals

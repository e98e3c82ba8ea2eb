"""Unfactored PyTorch oracles for the batch-cluster and modified-charge
kernels (port of `repro/kernels/ref.py`).

Written in the textbook form (direct Eq. 9/11/12 evaluation), so they
check the factored, tiled kernels independently. They materialize
O(B*S*NB*m) intermediates: test-scale shapes only.
"""
from __future__ import annotations

import torch

from repro_torch.core import cheby
from repro_torch.core.potentials import Kernel
from repro_torch.core.space import FREE as _FREE


def ref_batch_cluster_eval(
    idx: torch.Tensor,      # (B, S) int, -1 = empty slot
    tgt: torch.Tensor,      # (B, NB, 3) padded target coordinates
    src_pts: torch.Tensor,  # (C, m, 3) per-cluster source/Chebyshev points
    src_q: torch.Tensor,    # (C, m) charges / modified charges (0 = padding)
    kernel: Kernel,
    params=None,
    space=_FREE,
) -> torch.Tensor:
    """phi[b, i] = sum_s sum_j G(tgt[b,i], pts[idx[b,s], j]) q[idx[b,s], j]."""
    safe = idx.clamp(min=0).long()
    pts = src_pts[safe]                # (B, S, m, 3)
    q = src_q[safe]                    # (B, S, m)
    d = space.displacement(tgt[:, None, :, None, :], pts[:, :, None, :, :])
    g = kernel((d * d).sum(-1), params)  # masked at r2 == 0
    valid = (idx >= 0).to(tgt.dtype)
    return torch.einsum("bsnm,bsm,bs->bn", g, q, valid)


def ref_modified_charges(
    pts: torch.Tensor,  # (C, m, 3) cluster source particles (padded)
    q: torch.Tensor,    # (C, m) charges, 0 on padding
    lo: torch.Tensor,   # (C, 3)
    hi: torch.Tensor,   # (C, 3)
    degree: int,
) -> torch.Tensor:
    """Modified charges by direct evaluation of Eq. 12 (unfactored form),
    flattened k3-fastest as `cheby.cluster_grid` orders the grid."""
    dtype, device = pts.dtype, pts.device
    n1 = degree + 1
    s = cheby.cheb_points_1d(degree, dtype, device)
    w = cheby.bary_weights_1d(degree, dtype, device)
    rows = []
    for axis in range(3):
        s_ax = cheby.map_points(s, lo[:, axis:axis + 1], hi[:, axis:axis + 1])
        t, den = cheby.bary_terms(pts[..., axis], s_ax[:, None, :], w)
        rows.append(t / den[..., None])       # (C, m, n1) = L_k rows
    qhat = torch.einsum("zma,zmb,zmc,zm->zabc", rows[0], rows[1], rows[2], q)
    return qhat.reshape(-1, n1 * n1 * n1)


def ref_cluster_approx_potential(
    tgt: torch.Tensor,   # (NB, 3)
    lo: torch.Tensor,    # (3,)
    hi: torch.Tensor,    # (3,)
    qhat: torch.Tensor,  # ((n+1)^3,)
    degree: int,
    kernel: Kernel,
    params=None,
    space=_FREE,
) -> torch.Tensor:
    """Single batch-cluster approximation (Eq. 11) for diagnostics."""
    grid = cheby.cluster_grid(lo, hi, degree)  # ((n+1)^3, 3)
    return kernel.pairwise(tgt, grid, params, space) @ qhat

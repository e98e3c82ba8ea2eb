"""Backend dispatch around the CUDA kernels (port of `repro/kernels/ops.py`).

Backends:
  - "cuda":  the hand-written CUDA kernels; CUDA tensors only.
  - "torch": plain PyTorch on any device (the CPU path, and the
             yardstick the kernels are held against on the card).
  - "auto":  "cuda" for CUDA tensors, "torch" for CPU tensors.

A CUDA tensor under "auto" or "cuda" launches the kernel or raises:
there is no silent fallback to the plain version. All entry points take
the natural (..., P, 3) coordinate layout, which is also the kernels'.

`batch_boxes` and `mac_gate` (the Verlet-skin runtime MAC gate) are plain
torch ops, as the reference runs them in XLA outside Pallas.
"""
from __future__ import annotations

import torch

from repro_torch.core import cheby
from repro_torch.core.potentials import Kernel, pack_params
from repro_torch.core.space import FREE as _FREE
from repro_torch.kernels import batch_cluster as _bc
from repro_torch.kernels import modified_charges as _mc

BACKENDS = ("auto", "cuda", "torch")


def resolve_backend(backend: str, like: torch.Tensor) -> str:
    """The concrete backend ("cuda" | "torch") for tensors like `like`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if backend == "auto":
        return "cuda" if like.is_cuda else "torch"
    if backend == "cuda" and not like.is_cuda:
        raise ValueError(f"backend='cuda' needs CUDA tensors, got "
                         f"{like.device}")
    return backend


# ---------------------------------------------------------------------------
# Runtime MAC gate (Verlet-skin dual lists, DESIGN.md §4)
# ---------------------------------------------------------------------------


def batch_boxes(tgt: torch.Tensor, mask: torch.Tensor):
    """Current batch geometry from the padded target slab.

    tgt (B, NB, 3) batch-packed targets, mask (B, NB) validity. Returns
    (center (B, 3), half_extent (B, 3), radius (B,), has (B,)); fully
    padded rows collapse to a point box at the origin, excluded by `has`.
    """
    big = torch.finfo(tgt.dtype).max
    m = mask[..., None]
    lo = torch.where(m, tgt, torch.full_like(tgt, big)).amin(dim=1)
    hi = torch.where(m, tgt, torch.full_like(tgt, -big)).amax(dim=1)
    has = mask.any(dim=1)
    zero = torch.zeros_like(lo)
    lo = torch.where(has[:, None], lo, zero)
    hi = torch.where(has[:, None], hi, zero)
    hw = 0.5 * (hi - lo)
    return 0.5 * (lo + hi), hw, torch.linalg.vector_norm(hw, dim=-1), has


def mac_gate(node_idx: torch.Tensor, bc, bhw, rb, has,
             node_lo: torch.Tensor, node_hi: torch.Tensor, *,
             theta: float, space=_FREE) -> torch.Tensor:
    """(B, S) bool: MAC of (batch, node_idx[b, s]) holds on CURRENT boxes.

    Space-aware (minimum-image center distance and the fold-free
    condition under a `PeriodicBox`); -1 (sentinel) node ids gate to
    False."""
    safe = node_idx.clamp(min=0).long()
    clo = node_lo[safe]                               # (B, S, 3)
    chi = node_hi[safe]
    cc = 0.5 * (clo + chi)
    chw = 0.5 * (chi - clo)
    rc = torch.linalg.vector_norm(chw, dim=-1)
    d = bc[:, None, :] - cc
    dm = space.min_image(d)
    R = torch.sqrt((dm * dm).sum(-1))
    ok = theta * R - (rb[:, None] + rc) > 0.0
    fold = space.fold_margin(d, bhw[:, None, :] + chw)
    fold_ok = torch.as_tensor(fold > 0.0, device=ok.device)
    return ok & fold_ok & has[:, None] & (node_idx >= 0)


# ---------------------------------------------------------------------------
# batch-cluster evaluation (Eq. 9 / Eq. 11)
# ---------------------------------------------------------------------------


def batch_cluster_eval(
    idx: torch.Tensor,      # (B, S) int, -1 = empty slot
    tgt: torch.Tensor,      # (B, NB, 3)
    src_pts: torch.Tensor,  # (C, m, 3)
    src_q: torch.Tensor,    # (C, m)
    params=None,            # kernel parameter values (None: defaults)
    *,
    kernel: Kernel,
    space=_FREE,
    backend: str = "auto",
    kahan: bool = False,
    r2_mode: str = "diff",
) -> torch.Tensor:
    """phi (B, NB) = sum over list slots of batch-cluster interactions."""
    if resolve_backend(backend, tgt) == "cuda":
        par = pack_params(kernel.params if params is None else params,
                          dtype=tgt.dtype, device=tgt.device)
        return _bc.batch_cluster_eval_cuda(
            idx.to(torch.int32).contiguous(), par, tgt.contiguous(),
            src_pts.contiguous(), src_q.contiguous(), kernel=kernel,
            space=space, kahan=kahan, r2_mode=r2_mode)
    return _bc.batch_cluster_eval_plain(
        idx, tgt, src_pts, src_q, params, kernel=kernel, space=space,
        kahan=kahan, r2_mode=r2_mode)


# ---------------------------------------------------------------------------
# modified charges (Eq. 12 via the factored 14/15 form)
# ---------------------------------------------------------------------------
#
# Space-independent on purpose: barycentric interpolation is LOCAL to a
# cluster box, and particle coordinates are stored consistently with their
# own cluster, so no image folding can occur between a particle and its
# cluster's Chebyshev grid.


def _cluster_nodes(lo: torch.Tensor, hi: torch.Tensor, degree: int):
    """Per-dimension mapped Chebyshev nodes, (C, 3, n+1)."""
    s = cheby.cheb_points_1d(degree, lo.dtype, lo.device)
    return cheby.map_points(s, lo[..., None], hi[..., None])


def modified_charges(
    pts: torch.Tensor,  # (C, m, 3) cluster particles, padded (q = 0)
    q: torch.Tensor,    # (C, m)
    lo: torch.Tensor,   # (C, 3)
    hi: torch.Tensor,   # (C, 3)
    *,
    degree: int,
    backend: str = "auto",
) -> torch.Tensor:
    """q_hat (C, (n+1)^3), flattened k3-fastest (cluster_grid ordering)."""
    nodes = _cluster_nodes(lo, hi, degree)
    w = cheby.bary_weights_1d(degree, pts.dtype, pts.device)
    if resolve_backend(backend, pts) == "cuda":
        return _mc.modified_charges_cuda(
            pts.contiguous(), q.contiguous(), nodes.contiguous(), w, degree)
    return _mc.modified_charges_plain(pts, q, nodes, w, degree)

"""Backend dispatch around the CUDA kernels (port of `repro/kernels/ops.py`).

Backends:
  - "cuda":  the hand-written CUDA kernels; CUDA tensors only.
  - "torch": plain PyTorch on any device (the CPU path, and the
             yardstick the kernels are held against on the card).
  - "auto":  "cuda" for CUDA tensors, "torch" for CPU tensors.
  - "meta":  shapes only, for tensors on the meta device (the dry run
             of the sharded plan, `launch/dryrun_bltc.py`): each entry
             the sharded executor reaches (the three batch-cluster
             entries and `modified_charges_ranged`) returns an empty
             meta tensor of its output's shape, as the kernel would
             allocate it, and computes nothing. A meta tensor takes this
             branch under any backend but "cuda", which raises.

A CUDA tensor under "auto" or "cuda" launches the kernel or raises:
there is no silent fallback to the plain version. All entry points take
the natural (..., P, 3) coordinate layout, which is also the kernels'.

Every entry point also takes a leading systems axis W on every operand
(an ensemble of systems of one shape, `repro_torch.serve`): idx
(W, B, S), tgt (W, B, NB, 3) and so on, parameter leaves with a leading
W. One call is then one launch per kernel over all W systems; `take`
gathers per system the same way for the code around the kernels.

`batch_boxes`, `mac_gate` (the Verlet-skin runtime MAC gate) and
`refreshed_slacks` (the MD engine's drift budgets) are plain torch ops,
as the reference runs them in XLA outside Pallas.

Under ``REPRO_DEBUG_NANS=1`` (`repro_torch.lint.runtime`) every kernel
entry checks its output and raises `FloatingPointError` naming itself.
"""
from __future__ import annotations

import torch

from repro_torch.core import cheby
from repro_torch.core.potentials import Kernel, pack_params
from repro_torch.core.space import FREE as _FREE
from repro_torch.kernels import batch_cluster as _bc
from repro_torch.kernels import modified_charges as _mc
from repro_torch.lint import runtime as _rt

BACKENDS = ("auto", "cuda", "torch")


def resolve_backend(backend: str, like: torch.Tensor) -> str:
    """The concrete backend ("cuda" | "torch" | "meta") for tensors like
    `like`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if like.is_meta:
        if backend == "cuda":
            raise ValueError("backend='cuda' needs CUDA tensors, got meta")
        return "meta"
    if backend == "auto":
        return "cuda" if like.is_cuda else "torch"
    if backend == "cuda" and not like.is_cuda:
        raise ValueError(f"backend='cuda' needs CUDA tensors, got "
                         f"{like.device}")
    return backend


def take(x: torch.Tensor, idx: torch.Tensor, stacked: bool) -> torch.Tensor:
    """x[idx] along x's leading axis (idx >= 0). With ``stacked`` both
    carry a leading systems axis, x (W, N, ...) and idx (W, ...), and
    system w's indices pick from x[w]: (W, *idx.shape[1:], ...)."""
    if not stacked:
        return x[idx]
    w, n = x.shape[:2]
    off = torch.arange(0, w * n, n, device=idx.device)
    return x.flatten(0, 1)[idx + off.view((w,) + (1,) * (idx.dim() - 1))]


# ---------------------------------------------------------------------------
# Runtime MAC gate (Verlet-skin dual lists, DESIGN.md §4)
# ---------------------------------------------------------------------------


def batch_boxes(tgt: torch.Tensor, mask: torch.Tensor):
    """Current batch geometry from the padded target slab.

    tgt (B, NB, 3) batch-packed targets, mask (B, NB) validity. Returns
    (center (B, 3), half_extent (B, 3), radius (B,), has (B,)); fully
    padded rows collapse to a point box at the origin, excluded by `has`.
    A leading systems axis carries through.
    """
    big = torch.finfo(tgt.dtype).max
    m = mask[..., None]
    lo = torch.where(m, tgt, torch.full_like(tgt, big)).amin(dim=-2)
    hi = torch.where(m, tgt, torch.full_like(tgt, -big)).amax(dim=-2)
    has = mask.any(dim=-1)
    zero = torch.zeros_like(lo)
    lo = torch.where(has[..., None], lo, zero)
    hi = torch.where(has[..., None], hi, zero)
    hw = 0.5 * (hi - lo)
    return 0.5 * (lo + hi), hw, torch.linalg.vector_norm(hw, dim=-1), has


def mac_gate(node_idx: torch.Tensor, bc, bhw, rb, has,
             node_lo: torch.Tensor, node_hi: torch.Tensor, *,
             theta: float, space=_FREE) -> torch.Tensor:
    """(B, S) bool: MAC of (batch, node_idx[b, s]) holds on CURRENT boxes.

    Space-aware (minimum-image center distance and the fold-free
    condition under a `PeriodicBox`); -1 (sentinel) node ids gate to
    False. Nodes (W, C, 3) mean a leading systems axis on every input."""
    safe = node_idx.clamp(min=0).long()
    stacked = node_lo.dim() == 3
    clo = take(node_lo, safe, stacked)                # (B, S, 3)
    chi = take(node_hi, safe, stacked)
    cc = 0.5 * (clo + chi)
    chw = 0.5 * (chi - clo)
    rc = torch.linalg.vector_norm(chw, dim=-1)
    d = bc[..., None, :] - cc
    dm = space.min_image(d)
    R = torch.sqrt((dm * dm).sum(-1))
    ok = theta * R - (rb[..., None] + rc) > 0.0
    # free space gives a host scalar (+inf): a Python bool, no upload
    fold_ok = space.fold_margin(d, bhw[..., None, :] + chw) > 0.0
    return ok & fold_ok & has[..., None] & (node_idx >= 0)


def refreshed_slacks(approx_idx: torch.Tensor, approx_skin: torch.Tensor,
                     bc, bhw, rb, has, node_lo: torch.Tensor,
                     node_hi: torch.Tensor, *, theta: float, space=_FREE):
    """(theta_slack, fold_slack) 0-d tensors over the SAFE approx pairs of
    a refitted plan: the on-device slack refresh (DESIGN.md §4).

    Margins are exact on the current geometry (refitted boxes are true
    bounding boxes), so the MD engine may budget future drift against
    them. Skin pairs (approx_skin != 0) are runtime gated and excluded;
    empty categories reduce to +inf. Nothing here waits for the host."""
    safe = approx_idx.clamp(min=0).long()
    clo = node_lo[safe]
    chi = node_hi[safe]
    cc = 0.5 * (clo + chi)
    chw = 0.5 * (chi - clo)
    rc = torch.linalg.vector_norm(chw, dim=-1)
    d = bc[..., None, :] - cc
    dm = space.min_image(d)
    R = torch.sqrt((dm * dm).sum(-1))
    t_margin = theta * R - (rb[..., None] + rc)
    valid = (approx_idx >= 0) & (approx_skin == 0) & has[..., None]
    inf = torch.full((), float("inf"), dtype=t_margin.dtype,
                     device=t_margin.device)
    theta_slack = torch.where(valid, t_margin, inf).amin()
    fold = space.fold_margin(d, bhw[..., None, :] + chw)
    if not isinstance(fold, torch.Tensor):   # free space: +inf, no upload
        fold = torch.full_like(t_margin, fold)
    return theta_slack, torch.where(valid, fold, inf).amin()


# ---------------------------------------------------------------------------
# batch-cluster evaluation (Eq. 9 / Eq. 11)
# ---------------------------------------------------------------------------


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    """The meta backend's output: `shape` on the meta device."""
    return torch.empty(shape, dtype=like.dtype, device="meta")


def _checked(out: torch.Tensor, op: str) -> torch.Tensor:
    """`out`, checked for NaN and infinity under REPRO_DEBUG_NANS."""
    if _rt.DEBUG_NANS:
        _rt.check_finite(out, op)
    return out


def _packed(kernel: Kernel, params, idx, tgt) -> torch.Tensor:
    """The launch's packed parameters: (P,), or (W, P) for stacked
    operands (idx (W, B, S))."""
    return pack_params(kernel.params if params is None else params,
                       dtype=tgt.dtype, device=tgt.device,
                       systems=idx.shape[0] if idx.dim() == 3 else None)


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
    tgt_count: torch.Tensor | None = None,  # (B,) real targets per row
    src_count: torch.Tensor | None = None,  # (C,) real points per cluster
) -> torch.Tensor:
    """phi (B, NB) = sum over list slots of batch-cluster interactions.

    With counts, only the first `src_count[c]` points of a cluster are
    summed and phi is 0 on target slots at or beyond `tgt_count[b]` (the
    count contract of `kernels/batch_cluster.py`)."""
    be = resolve_backend(backend, tgt)
    if be == "meta":
        return _empty(tgt.shape[:-1], tgt)
    if be == "cuda":
        par = _packed(kernel, params, idx, tgt)
        counts = [None if c is None else c.to(torch.int32).contiguous()
                  for c in (tgt_count, src_count)]
        out = _bc.batch_cluster_eval_cuda(
            idx.to(torch.int32).contiguous(), par, tgt.contiguous(),
            src_pts.contiguous(), src_q.contiguous(), kernel=kernel,
            space=space, kahan=kahan, r2_mode=r2_mode, tgt_count=counts[0],
            src_count=counts[1])
    else:
        out = _bc.batch_cluster_eval_plain(
            idx, tgt, src_pts, src_q, params, kernel=kernel, space=space,
            kahan=kahan, r2_mode=r2_mode, tgt_count=tgt_count,
            src_count=src_count)
    return _checked(out, "batch_cluster_eval")


def batch_cluster_field(
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
    tgt_count: torch.Tensor | None = None,  # (B,) real targets per row
    src_count: torch.Tensor | None = None,  # (C,) real points per cluster
) -> torch.Tensor:
    """(B, NB, 4): phi and its gradient with respect to each target,
    sum over list slots, under the count contract of `batch_cluster_eval`.

    The CUDA field kernel always takes the difference form of r^2 (the
    gradient needs the displacement); the plain version follows
    `r2_mode` like the potential, so the two differ by rounding only."""
    be = resolve_backend(backend, tgt)
    if be == "meta":
        return _empty(tgt.shape[:-1] + (4,), tgt)
    if be == "cuda":
        par = _packed(kernel, params, idx, tgt)
        counts = [None if c is None else c.to(torch.int32).contiguous()
                  for c in (tgt_count, src_count)]
        out = _bc.batch_cluster_field_cuda(
            idx.to(torch.int32).contiguous(), par, tgt.contiguous(),
            src_pts.contiguous(), src_q.contiguous(), kernel=kernel,
            space=space, kahan=kahan, tgt_count=counts[0],
            src_count=counts[1])
    else:
        out = _bc.batch_cluster_field_plain(
            idx, tgt, src_pts, src_q, params, kernel=kernel, space=space,
            kahan=kahan, r2_mode=r2_mode, tgt_count=tgt_count,
            src_count=src_count)
    return _checked(out, "batch_cluster_field")


def batch_cluster_field_grid(
    idx: torch.Tensor,      # (B, S) int, -1 = empty slot
    tgt: torch.Tensor,      # (B, NB, 3)
    nodes: torch.Tensor,    # (C, 3, n+1) 1-D Chebyshev nodes per cluster
    q_hat: torch.Tensor,    # (C, (n+1)^3), k3 fastest
    params=None,            # kernel parameter values (None: defaults)
    *,
    kernel: Kernel,
    space=_FREE,
    backend: str = "auto",
    kahan: bool = False,
    tgt_count: torch.Tensor | None = None,  # (B,) real targets per row
) -> torch.Tensor:
    """(B, NB, 4): `batch_cluster_field` over each cluster's tensor-product
    Chebyshev grid (`cheby.cluster_grid` of the box `nodes` come from,
    `_cluster_nodes`), taken in factored form: the approximation lane of
    the forces. The difference form of r^2 on both backends; every grid
    point is real, so there are target counts only."""
    be = resolve_backend(backend, tgt)
    if be == "meta":
        return _empty(tgt.shape[:-1] + (4,), tgt)
    if be == "cuda":
        par = _packed(kernel, params, idx, tgt)
        count = (None if tgt_count is None
                 else tgt_count.to(torch.int32).contiguous())
        out = _bc.batch_cluster_field_grid_cuda(
            idx.to(torch.int32).contiguous(), par, tgt.contiguous(),
            nodes.contiguous(), q_hat.contiguous(), kernel=kernel,
            space=space, kahan=kahan, tgt_count=count)
    else:
        out = _bc.batch_cluster_field_grid_plain(
            idx, tgt, nodes, q_hat, params, kernel=kernel, space=space,
            kahan=kahan, tgt_count=tgt_count)
    return _checked(out, "batch_cluster_field_grid")


# ---------------------------------------------------------------------------
# modified charges (Eq. 12 via the factored 14/15 form)
# ---------------------------------------------------------------------------
#
# Space-independent on purpose: barycentric interpolation is LOCAL to a
# cluster box, and particle coordinates are stored consistently with their
# own cluster, so no image folding can occur between a particle and its
# cluster's Chebyshev grid.


def _cluster_nodes(lo: torch.Tensor, hi: torch.Tensor, degree: int):
    """Per-dimension mapped Chebyshev nodes, (C, 3, n+1): bitwise the
    coordinates `cheby.cluster_grid` builds from the same boxes."""
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
        out = _mc.modified_charges_cuda(
            pts.contiguous(), q.contiguous(), nodes.contiguous(), w, degree)
    else:
        out = _mc.modified_charges_plain(pts, q, nodes, w, degree)
    return _checked(out, "modified_charges")


def modified_charges_ranged(
    src_sorted: torch.Tensor,  # (N, 3) tree-ordered particles
    q_sorted: torch.Tensor,    # (N,)
    chunks: torch.Tensor,      # (K, 3) int32 rows (node, begin, end)
    chunk_ptr: torch.Tensor,   # (num_nodes + 1,) int32
    node_lo: torch.Tensor,     # (num_nodes, 3)
    node_hi: torch.Tensor,     # (num_nodes, 3)
    *,
    degree: int,
    backend: str = "auto",
) -> torch.Tensor:
    """q_hat (num_nodes, (n+1)^3) of every node from its own particles.

    Node i's particles are the rows chunk_ptr[i] to chunk_ptr[i+1] of
    `chunks` (`modified_charges.chunk_table`, which the plan holds as
    `mc_chunks` / `mc_chunk_ptr`); a node without chunks gets q_hat 0.
    With a leading systems axis on every input, (W, num_nodes, (n+1)^3)
    from one call (two launches on the card)."""
    be = resolve_backend(backend, src_sorted)
    if be == "meta":
        return _empty(node_lo.shape[:-1] + ((degree + 1) ** 3,), src_sorted)
    nodes = _cluster_nodes(node_lo, node_hi, degree)
    w = cheby.bary_weights_1d(degree, src_sorted.dtype, src_sorted.device)
    if be == "cuda":
        out = _mc.modified_charges_ranged_cuda(
            src_sorted.contiguous(), q_sorted.contiguous(),
            chunks.to(torch.int32).contiguous(),
            chunk_ptr.to(torch.int32).contiguous(), nodes.contiguous(), w,
            degree)
    else:
        out = _mc.modified_charges_ranged_plain(
            src_sorted, q_sorted, chunks, chunk_ptr, nodes, w, degree)
    return _checked(out, "modified_charges_ranged")


def modified_charges_transpose_ranged(
    src_sorted: torch.Tensor,  # (N, 3) tree-ordered particles
    qhat_bar: torch.Tensor,    # (num_nodes, (n+1)^3) cotangent of q_hat
    tiles: torch.Tensor,       # (S, 2) int32 particle ranges [begin, end)
    chain: torch.Tensor,       # (S, L) int32 nodes per tile, root first
    node_lo: torch.Tensor,     # (num_nodes, 3)
    node_hi: torch.Tensor,     # (num_nodes, 3)
    *,
    degree: int,
    backend: str = "auto",
) -> torch.Tensor:
    """qbar (N,): the transpose of `modified_charges_ranged` applied to
    `qhat_bar`, over the work table of `modified_charges.tile_table`
    (each tile's particles take the contraction with every node of its
    chain, in chain order), on the nodes `_cluster_nodes` maps from the
    boxes (the kernel maps them itself, bitwise the same). One system;
    one launch on the card."""
    if resolve_backend(backend, src_sorted) == "cuda":
        out = _mc.modified_charges_transpose_ranged_cuda(
            src_sorted.contiguous(), qhat_bar.contiguous(),
            tiles.to(torch.int32).contiguous(),
            chain.to(torch.int32).contiguous(), node_lo.contiguous(),
            node_hi.contiguous(), degree)
    else:
        out = _mc.modified_charges_transpose_ranged_plain(
            src_sorted, qhat_bar, tiles, chain, node_lo, node_hi, degree)
    return _checked(out, "modified_charges_transpose_ranged")

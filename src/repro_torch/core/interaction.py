"""Uniform-MAC interaction lists (Sec. 2.4 algorithm + Sec. 3.2 batching).

For every target batch B the source tree is traversed with the
multipole acceptance criterion (Eq. 13)

    (r_B + r_C) / R < theta     and     (n+1)^3 < N_C,

applied *uniformly to the whole batch* (the paper's divergence-free GPU
choice). The traversal yields, per batch:

  - an APPROX list of cluster node ids (evaluated via Eq. 11 against the
    cluster's Chebyshev grid and modified charges), and
  - a DIRECT list of *leaf slots* (evaluated via Eq. 9 against the leaf's
    source particles). A direct interaction with an internal cluster (the
    (n+1)^3 >= N_C branch) is decomposed into its constituent leaves so the
    device pipeline only ever sees fixed-stride leaf blocks.

Space-aware MAC (kernel protocol v2): under a `PeriodicBox`, R is the
MINIMUM-IMAGE center distance, and a pair is accepted for approximation
only when it is additionally *fold-free* (`Space.fold_margin` > 0): no
coordinate of any target-source displacement in the pair can cross a
half-box boundary, so the minimum image is one rigid shift of the whole
cluster and the free-space barycentric error theory applies verbatim
(DESIGN.md §5). Pairs that straddle a fold recurse deeper and bottom out
in per-pair (exact) direct evaluation.

Verlet-skin drift tolerance (DESIGN.md §4, drift-budget v2): with
``skin > 0`` every MAC-accepted pair is classified by whether its margins
survive a worst-case per-particle drift of ``skin/2``:

  - SAFE pairs (theta margin > 2*sqrt(3)*(1+theta)*skin/2 and raw fold
    margin > 4*skin/2) stay pure approx entries and are the ONLY pairs
    that enter the recorded ``theta_slack`` / ``fold_slack`` minima — so
    the engine's drift budget is floored at skin/2 by construction;
  - SKIN pairs (MAC-valid now, but within the skin of the acceptance
    boundary) are DUAL-LISTED: their approx slot is flagged in
    ``approx_skin`` and their leaf decomposition goes into the gated
    ``skin_direct`` list (with the owning cluster node recorded per slot
    in ``skin_direct_node``). At evaluation time the executors re-test
    the pair's MAC on the CURRENT (refitted) geometry and route it to
    exactly one side — approx while the MAC holds, exact direct once it
    fails — by masking the losing side's index to the ``-1`` sentinel
    the kernels already skip. Skin pairs are therefore self-validating
    for ANY drift and never constrain the drift budget.

The traversal is a vectorized level-synchronous frontier sweep over
(batch, node) pairs — the NumPy analogue of the paper's per-batch recursive
COMPUTEPOTENTIAL — and the ragged results are padded with -1 sentinels into
rectangular arrays for the static device kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.space import FreeSpace
from repro_torch.core.tree import Batches, Tree
from repro_torch.obs.trace import traced as _traced

# Margin shrink rates per unit of particle drift (DESIGN.md §4): each box
# endpoint moves <= drift per coordinate, so each half-diagonal grows and
# each center moves by at most sqrt(3)*drift — the theta margin
# theta*R - (r_B + r_C) shrinks by at most 2*sqrt(3)*(1 + theta)*drift.
# The fold margin shrinks by at most 4*drift (the center-to-center
# coordinate changes <= 2*drift and the two per-dimension half-extents
# grow <= drift each). The engine guards the two budgets SEPARATELY at
# their own rates; `mac_slack` folds them into one number (fold margins
# scaled by theta_rate/4) only for backward compatibility.
_FOLD_DRIFT_RATE = 4.0


def theta_drift_rate(theta: float) -> float:
    """Worst-case theta-margin shrink rate per unit of particle drift."""
    return 2.0 * np.sqrt(3.0) * (1.0 + theta)


def fold_drift_rate() -> float:
    """Worst-case fold-margin shrink rate per unit of particle drift."""
    return _FOLD_DRIFT_RATE


@dataclasses.dataclass
class InteractionLists:
    """Padded per-batch interaction lists (-1 = empty slot)."""

    approx: np.ndarray  # (B, A_max) source-tree node ids
    direct: np.ndarray  # (B, D_max) leaf slots (indices into tree.leaf_ids)
    # Diagnostics (EXPERIMENTS.md padding-overhead reporting):
    approx_counts: np.ndarray  # (B,)
    direct_counts: np.ndarray  # (B,)
    # Verlet-skin dual lists (empty all--1 rows when skin == 0):
    #   approx_skin[b, s] == 1 marks approx[b, s] as a SKIN pair whose
    #   runtime MAC gate decides approx-vs-direct each evaluation;
    #   skin_direct[b, j] holds the leaf decomposition of the skin pairs,
    #   skin_direct_node[b, j] the owning cluster node of each slot (the
    #   gate is evaluated per owning node, complementary on both sides).
    approx_skin: np.ndarray = None      # (B, A_max) uint8
    skin_direct: np.ndarray = None      # (B, SD_max)
    skin_direct_node: np.ndarray = None  # (B, SD_max)
    # Min margins over SAFE approx pairs only (skin pairs are runtime
    # gated and never constrain the budget), in RAW units: `theta_slack`
    # shrinks at rate theta_drift_rate(theta), `fold_slack` at rate 4.
    # +inf when no (safe) approx interactions exist in a category.
    theta_slack: float = float("inf")
    fold_slack: float = float("inf")
    skin: float = 0.0
    # Backward-compatible single slack: min(theta_slack, fold_slack
    # scaled to theta-rate units) — the v1 drift trigger's quantity.
    mac_slack: float = float("inf")

    @property
    def padding_waste(self) -> float:
        """Fraction of padded slots that are sentinels (wasted kernel work)."""
        total = self.approx.size + self.direct.size
        used = self.approx_counts.sum() + self.direct_counts.sum()
        return 1.0 - used / max(total, 1)


def _pad_ragged(pairs_b: np.ndarray, pairs_v: np.ndarray, num_batches: int):
    """Scatter (batch, value) pairs into a (B, max_count) -1-padded array."""
    order = np.argsort(pairs_b, kind="stable")
    b = pairs_b[order]
    v = pairs_v[order]
    counts = np.bincount(b, minlength=num_batches)
    width = int(counts.max()) if len(b) else 0
    width = max(width, 1)  # keep kernels shape-valid even for empty lists
    out = np.full((num_batches, width), -1, dtype=np.int64)
    # slot of each pair within its batch row
    row_start = np.zeros(num_batches + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])
    slot = np.arange(len(b)) - row_start[b]
    out[b, slot] = v
    return out, counts


def batch_half_extents(batches: Batches) -> np.ndarray:
    """(B, 3) per-dimension batch half-extents; pre-v2 `Batches` built
    without them fall back to the (per-dim conservative) radius."""
    if batches.half_extent is not None:
        return batches.half_extent
    return np.broadcast_to(batches.radius[:, None], batches.center.shape)


def mac_accept(space, theta: float, d_center: np.ndarray,
               rb: np.ndarray, rc: np.ndarray, spread_dim: np.ndarray):
    """Vectorized space-aware MAC distance test.

    Returns (dist_ok, fold_ok, theta_margin, fold_margin) for center
    displacements `d_center` (pre-fold; min-imaged here), batch/cluster
    half-diagonal radii rb/rc (the paper's Eq. 13 quantities) and
    per-dimension spreads `spread_dim` (..., 3) = batch + cluster box
    half-extents (the exact per-coordinate deviation bound the fold-free
    condition needs). Margins are RAW: the theta margin shrinks at rate
    `theta_drift_rate(theta)` per unit of drift, the fold margin at rate
    `fold_drift_rate()` (= 4). Shared by the local traversal below and
    the cross-rank traversals of a sharded plan.
    """
    d = space.min_image(d_center)
    R = np.linalg.norm(np.asarray(d), axis=-1)
    theta_margin = theta * R - (rb + rc)
    dist_ok = theta_margin > 0.0
    # FreeSpace returns a scalar +inf; broadcast so masks line up.
    fold = np.broadcast_to(
        np.asarray(space.fold_margin(d_center, spread_dim), dtype=float),
        np.shape(theta_margin))
    fold_ok = fold > 0.0
    return dist_ok, fold_ok, theta_margin, fold


def scaled_mac_slack(theta: float, theta_slack: float,
                     fold_slack: float) -> float:
    """Fold both raw slacks into one theta-rate number (v1 compat)."""
    scale = theta_drift_rate(theta) / _FOLD_DRIFT_RATE
    return float(min(theta_slack, fold_slack * scale))


@_traced("interaction.build_lists")
def build_interaction_lists(
    tree: Tree,
    batches: Batches,
    theta: float,
    degree: int,
    space=FreeSpace(),
    skin: float = 0.0,
) -> InteractionLists:
    """Dual traversal of all batches against the source tree (Eq. 13).

    `skin` >= 0 is the Verlet-skin radius (module docstring): pairs whose
    margins would not survive a worst-case drift of skin/2 are dual-listed
    with a runtime MAC gate instead of contributing to the slack minima.
    """
    if skin < 0.0:
        raise ValueError(f"skin must be >= 0, got {skin}")
    npts = (degree + 1) ** 3
    nb = batches.num_batches
    thr_theta = theta_drift_rate(theta) * 0.5 * skin
    thr_fold = _FOLD_DRIFT_RATE * 0.5 * skin

    approx_b, approx_v, approx_f = [], [], []
    direct_b, direct_v = [], []
    skin_b, skin_v, skin_n = [], [], []
    theta_slack = float("inf")
    fold_slack = float("inf")

    # Frontier of candidate (batch, node) pairs, starting at the root.
    fb = np.arange(nb, dtype=np.int64)
    fn = np.zeros(nb, dtype=np.int64)
    bhw = batch_half_extents(batches)
    chw = 0.5 * (tree.hi - tree.lo)
    while fb.size:
        rb = batches.radius[fb]
        rc = tree.radius[fn]
        d = batches.center[fb] - tree.center[fn]
        nc = tree.count[fn]
        leaf = tree.is_leaf[fn]
        # Guard R == 0 (a batch co-located with a cluster center): MAC fails.
        dist_ok, fold_ok, t_margin, f_margin = mac_accept(
            space, theta, d, rb, rc, bhw[fb] + chw[fn])
        size_ok = npts < nc
        mac = dist_ok & size_ok & fold_ok
        safe = mac & (t_margin > thr_theta) & (f_margin > thr_fold)
        skinp = mac & ~safe

        if np.any(safe):
            approx_b.append(fb[safe])
            approx_v.append(fn[safe])
            approx_f.append(np.zeros(int(safe.sum()), np.uint8))
            theta_slack = min(theta_slack, float(t_margin[safe].min()))
            fm = f_margin[safe]
            fm = fm[np.isfinite(fm)]
            if fm.size:
                fold_slack = min(fold_slack, float(fm.min()))
        if np.any(skinp):
            # Dual listing: a flagged approx slot plus the node's leaf
            # decomposition in the gated skin-direct list.
            approx_b.append(fb[skinp])
            approx_v.append(fn[skinp])
            approx_f.append(np.ones(int(skinp.sum()), np.uint8))
            for b, node in zip(fb[skinp], fn[skinp]):
                slots = tree.leaves_in_range(int(tree.start[node]),
                                             int(tree.count[node]))
                skin_b.append(np.full(len(slots), b, dtype=np.int64))
                skin_v.append(slots)
                skin_n.append(np.full(len(slots), node, dtype=np.int64))

        # Not accepted. Leaves always go direct (per-pair evaluation is
        # exact in any space); internal clusters recurse unless the MAC
        # failed only on cluster size ((n+1)^3 >= N_C, fold irrelevant for
        # direct work), in which case they decompose into their leaves.
        go_direct = ~mac & leaf
        small_internal = ~mac & ~leaf & dist_ok & ~size_ok
        recurse = ~mac & ~leaf & ~small_internal

        if np.any(go_direct):
            direct_b.append(fb[go_direct])
            direct_v.append(tree.leaf_index[fn[go_direct]])
        for b, node in zip(fb[small_internal], fn[small_internal]):
            slots = tree.leaves_in_range(int(tree.start[node]), int(tree.count[node]))
            direct_b.append(np.full(len(slots), b, dtype=np.int64))
            direct_v.append(slots)

        if np.any(recurse):
            kids = tree.children[fn[recurse]]          # (m, 8)
            keep = kids >= 0
            fb = np.repeat(fb[recurse], keep.sum(axis=1))
            fn = kids[keep]
        else:
            fb = np.empty(0, dtype=np.int64)
            fn = np.empty(0, dtype=np.int64)

    def _cat(chunks, dtype=np.int64):
        return (np.concatenate(chunks) if chunks
                else np.empty(0, dtype=dtype))

    ab, av = _cat(approx_b), _cat(approx_v)
    af = _cat(approx_f, np.uint8)
    db, dv = _cat(direct_b), _cat(direct_v)
    approx, a_counts = _pad_ragged(ab, av, nb)
    direct, d_counts = _pad_ragged(db, dv, nb)
    # Skin flags ride in the same slot layout as the approx ids.
    approx_skin, _ = _pad_ragged(ab, af.astype(np.int64), nb)
    approx_skin = np.where(approx >= 0, approx_skin, 0).astype(np.uint8)
    sb = _cat(skin_b)
    skin_direct, _ = _pad_ragged(sb, _cat(skin_v), nb)
    skin_direct_node, _ = _pad_ragged(sb, _cat(skin_n), nb)
    return InteractionLists(
        approx=approx, direct=direct,
        approx_counts=a_counts, direct_counts=d_counts,
        approx_skin=approx_skin,
        skin_direct=skin_direct, skin_direct_node=skin_direct_node,
        theta_slack=theta_slack, fold_slack=fold_slack, skin=float(skin),
        mac_slack=scaled_mac_slack(theta, theta_slack, fold_slack),
    )

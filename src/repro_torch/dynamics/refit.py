"""Device-side tree refit: moved particles, fixed topology.

Port of `repro/dynamics/refit.py`. A treecode plan is (topology, geometry): the permutation, particle ranges,
interaction lists, padded gather tables and the modified charges' chunk
table are topology; the packed coordinates and node bounding boxes are
geometry. When particles move a little only the geometry is stale, and
all of it lives in the plan's device arrays. `refit_single_arrays`
recomputes exactly that, on the device, in O(N log N):

    src_sorted   <- x[perm]                  (tree-order source slab)
    tgt_batched  <- scatter x by gather_index (batch-packed target slab)
    node_lo/hi   <- masked min/max over each node's bucket-gather row

Chebyshev grids and modified charges are derived from node_lo/hi on
every force evaluation, so refitting the boxes refits them too; tree
order does not change, so the chunk table stays valid. Every particle
stays inside its refitted cluster box (the box IS the particle bounding
box); the only thing drift can invalidate is the MAC inequality of the
frozen approx lists, which the engine guards with the per-step drift
against the slacks `refresh_slacks_single` recomputes from the refitted
boxes (DESIGN.md §4). `refit_sharded_arrays` and
`refresh_slacks_sharded` do the same over a sharded plan's stacked rank
arrays.

`PlanAdapter` gives the engine one interface over both strategies
(`SingleDeviceAdapter`, `ShardedAdapter`): device-side `refit`, slacks
and forces (input-order positions in, input-order forces out), and
`rebuild`.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core import eval as _eval
from repro_torch.core.api import SingleDevicePlan
from repro_torch.distributed.bltc import (ShardedPlan, sharded_sweep,
                                          stage_ranks, unrank)
from repro_torch.kernels import ops as _ops


def _masked_boxes(pts, valid, old_lo_rows, old_hi_rows):
    """(rows, pad, 3) points + validity -> (rows, 3) min/max boxes.

    Rows with no valid entry (pure padding) keep their old box, which the
    padding convention fixed at the non-degenerate [0, 1]: every padded
    bucket row names the scratch node, so all of a level's writes to the
    scratch row carry the same [0, 1] box and the order in which
    `index_copy_` applies duplicates does not matter."""
    big = torch.finfo(pts.dtype).max
    m = valid[..., None]
    lo = torch.where(m, pts, torch.full_like(pts, big)).amin(dim=-2)
    hi = torch.where(m, pts, torch.full_like(pts, -big)).amax(dim=-2)
    has = valid.any(dim=-1)[..., None]
    return (torch.where(has, lo, old_lo_rows),
            torch.where(has, hi, old_hi_rows))


def refit_single_arrays(arrays: dict, x: torch.Tensor) -> dict:
    """A single-device plan's arrays refitted to positions `x` (input
    order), as a new dict; `arrays` is not modified.

    Assumes the MD setting: targets == sources == the N particles the
    plan was built over (gather_index covers every target once; under a
    point budget the padded entries all name the scratch batch row's
    first slot and their positions are equal, zero in
    `serve.EnsembleMD`). Stacked arrays (a leading systems axis) with x
    (W, N, 3) refit every system at once."""
    st = _eval.stacked(arrays)
    x = x.to(arrays["src_sorted"].dtype)
    src_sorted = _ops.take(x, arrays["src_perm"], st)
    lo = arrays["node_lo"].clone()
    hi = arrays["node_hi"].clone()
    # row offsets of each system in the flattened (W * rows) tables
    lead = x.shape[0] if st else 1
    flat_lo, flat_hi = lo.view(-1, 3), hi.view(-1, 3)
    node_off = _row_offsets(lead, lo.shape[-2], x.device)
    for gidx, nodes in zip(arrays["bucket_gather"], arrays["bucket_nodes"]):
        pts = _ops.take(src_sorted, gidx.clamp(min=0), st)
        rows = (nodes + node_off).flatten()
        lo_rows, hi_rows = _masked_boxes(pts.flatten(0, -3),
                                         (gidx >= 0).flatten(0, -2),
                                         flat_lo[rows], flat_hi[rows])
        flat_lo.index_copy_(0, rows, lo_rows)
        flat_hi.index_copy_(0, rows, hi_rows)
    b, nb = arrays["tgt_batched"].shape[-3:-1]
    slot = (arrays["gather_index"] + _row_offsets(lead, b * nb, x.device))
    flat = x.new_zeros((lead * b * nb, 3)).index_copy_(
        0, slot.flatten(), x.reshape(-1, 3))
    return dict(arrays, src_sorted=src_sorted, node_lo=lo, node_hi=hi,
                tgt_batched=flat.reshape(arrays["tgt_batched"].shape))


def _row_offsets(systems: int, rows: int, device) -> torch.Tensor:
    """(systems, 1) offsets of each system's rows in a flattened table."""
    return torch.arange(0, systems * rows, rows, device=device)[:, None]


def refit_sharded_arrays(arrays: dict, x: torch.Tensor, depth: int) -> dict:
    """A sharded plan's stacked (R, ...) arrays refitted to positions `x`
    (input order), as a new dict.

    `arrays` is the adapter's merged dict: the plan's stacked arrays and
    its rank tables (`rank_gather`, `input_pos`), so a rebuild swaps the
    tables with the arrays. The RCB rank assignment is frozen with the
    topology (particles may drift across slab boundaries; each rank's
    lists stay MAC-valid under the same slack bound). Every operation is
    batched over the rank axis."""
    x = x.to(arrays["src_sorted"].dtype)
    rank_gather = arrays["rank_gather"]                  # (R, per_pad)
    valid = rank_gather >= 0
    x_rank = torch.where(valid[..., None], x[rank_gather.clamp(min=0)],
                         torch.zeros((), dtype=x.dtype, device=x.device))
    src_sorted = _ops.take(x_rank, arrays["charges_perm"], True)
    lo = arrays["node_lo"].clone()
    hi = arrays["node_hi"].clone()
    r, m = lo.shape[:2]
    flat_lo, flat_hi = lo.view(-1, 3), hi.view(-1, 3)
    node_off = _row_offsets(r, m, x.device)
    for lvl in range(depth):
        gidx = arrays[f"bucket_gather_{lvl}"]            # (R, C, G)
        rows = (arrays[f"bucket_nodes_{lvl}"] + node_off).flatten()
        pts = _ops.take(src_sorted, gidx.clamp(min=0), True)
        lo_rows, hi_rows = _masked_boxes(pts.flatten(0, 1),
                                         (gidx >= 0).flatten(0, 1),
                                         flat_lo[rows], flat_hi[rows])
        flat_lo.index_copy_(0, rows, lo_rows)
        flat_hi.index_copy_(0, rows, hi_rows)
    b, nb = arrays["tgt_batched"].shape[1:3]
    # padded slab slots (x_rank 0) all land on one dropped extra slot
    gi = torch.where(valid, arrays["gather_index"], b * nb)
    slot = gi + _row_offsets(r, b * nb + 1, x.device)
    flat = x.new_zeros((r * (b * nb + 1), 3)).index_copy_(
        0, slot.flatten(), x_rank.reshape(-1, 3))
    return dict(arrays, src_sorted=src_sorted, node_lo=lo, node_hi=hi,
                tgt_batched=flat.view(r, b * nb + 1, 3)[:, :-1].reshape(
                    arrays["tgt_batched"].shape))


def refresh_slacks_single(arrays: dict, *, theta: float,
                          space) -> Tuple[torch.Tensor, torch.Tensor]:
    """(theta_slack, fold_slack) 0-d device tensors of a refitted
    single-device plan (+inf where no safe approx pair exists)."""
    bc, bhw, rb, has = _ops.batch_boxes(arrays["tgt_batched"],
                                        arrays["tgt_mask"])
    return _ops.refreshed_slacks(
        arrays["approx_idx"], arrays["approx_skin"], bc, bhw, rb, has,
        arrays["node_lo"], arrays["node_hi"], theta=theta, space=space)


def refresh_slacks_sharded(arrays: dict, *, theta: float, space,
                           ranks) -> Tuple[torch.Tensor, torch.Tensor]:
    """(theta_slack, fold_slack) over a sharded plan's stacked arrays.

    The local lists are offset into the flat (P*M) gathered node axis
    and reduced with the remote (LET) lists, whose entries already index
    it; the minimum then runs over every rank (`ranks.all_min`). Remote
    skin pairs are demoted at build, so every remote entry is a safe
    pair."""
    lo, hi = arrays["node_lo"], arrays["node_hi"]        # (R, M, 3)
    r, m = lo.shape[:2]
    g_lo = ranks.all_gather(lo).flatten(0, 1)
    g_hi = ranks.all_gather(hi).flatten(0, 1)
    tgt = arrays["tgt_batched"]                          # (R, B, NB, 3)
    b, nb = tgt.shape[1:3]
    bc, bhw, rb, has = _ops.batch_boxes(
        tgt.reshape(r * b, nb, 3), arrays["tgt_mask"].reshape(r * b, nb))
    off = ((torch.arange(r, device=lo.device) + ranks.first_rank)
           * m)[:, None, None]
    la = arrays["approx_idx"]
    la_f = torch.where(la >= 0, la + off, -1).reshape(r * b, -1)
    kw = dict(theta=theta, space=space)
    t_loc, f_loc = _ops.refreshed_slacks(
        la_f, arrays["approx_skin"].reshape(r * b, -1), bc, bhw, rb, has,
        g_lo, g_hi, **kw)
    ra = arrays["remote_approx_idx"].reshape(r * b, -1)
    t_rem, f_rem = _ops.refreshed_slacks(ra, torch.zeros_like(ra), bc, bhw,
                                         rb, has, g_lo, g_hi, **kw)
    both = ranks.all_min(torch.stack([torch.minimum(t_loc, t_rem),
                                      torch.minimum(f_loc, f_rem)]))
    return both[0], both[1]


def max_drift(x: torch.Tensor, x_ref: torch.Tensor,
              space=None) -> torch.Tensor:
    """Max particle displacement since `x_ref`, a 0-d device tensor.

    With a periodic `space` the displacement is folded to the minimum
    image, so a particle wrapped across the cell boundary at the last
    rebuild does not register a spurious box-length drift."""
    d = x - x_ref
    if space is not None:
        d = space.min_image(d)
    return torch.sqrt((d * d).sum(-1).max())


class PlanAdapter:
    """Strategy-specific hooks the dynamics engine composes into a step:
    `refit`, `slack_fn` and `force_fn` run on the device and never wait
    for the host; `rebuild` rebuilds the tree (on the host, the paper's
    setup phase, or on the device for ``build_backend="device"`` plans)
    and returns True when the plan's shapes changed (a capacity growth).
    Device-built plans also rebuild double-buffered:
    `rebuild_dispatch` enqueues a shadow build and `rebuild_commit` swaps
    it in."""

    plan = None
    #: The plan rebuilds on the device (positions never visit the host).
    device_rebuild = False
    #: `rebuild_dispatch` / `rebuild_commit` are available.
    supports_async_rebuild = False
    #: A budget growth changes what `force_fn` / `slack_fn` close over.
    recloses_on_rebuild = False

    def positions(self) -> torch.Tensor:
        """Current particle positions in input order, on the device."""
        raise NotImplementedError

    @property
    def arrays(self) -> dict:
        raise NotImplementedError

    @property
    def mac_slack(self) -> float:
        return self.plan.mac_slack

    @property
    def theta_slack(self) -> float:
        """Build-time raw theta-margin slack (drift rate 2√3(1+θ))."""
        return self.plan.theta_slack

    @property
    def fold_slack(self) -> float:
        """Build-time raw fold-margin slack (drift rate 4)."""
        return self.plan.fold_slack

    @property
    def skin(self) -> float:
        """Verlet-skin radius of the plan's interaction lists."""
        return self.plan.skin

    def signature(self) -> Tuple:
        raise NotImplementedError

    def refit(self, arrays: dict, x) -> dict:
        raise NotImplementedError

    def slack_fn(self) -> Callable:
        """(arrays) -> (theta_slack, fold_slack) device scalars
        recomputed from the REFITTED geometry."""
        raise NotImplementedError

    def force_fn(self) -> Callable:
        """(arrays, x, q, w) -> (phi, F), all input order, on device."""
        raise NotImplementedError

    def rebuild(self, x) -> bool:
        """Tree rebuild at new positions, re-padded into the plan's
        capacity budget; True only when a budget grew."""
        raise NotImplementedError

    def rebuild_dispatch(self, x):
        """Enqueue a shadow rebuild at positions `x` without waiting and
        without touching the live plan; returns a handle for
        `rebuild_commit`."""
        raise NotImplementedError

    def rebuild_commit(self, pending) -> Tuple[bool, float, bool]:
        """Swap the live plan for a dispatched shadow build. Returns
        ``(invalidated, wait_ms, grew)``: the plan's shapes changed, the
        host milliseconds spent waiting for the shadow build, and a
        budget overflowed (the handle rebuilt at a grown budget)."""
        raise NotImplementedError

    def sync_arrays(self, arrays: dict) -> None:
        """Push engine-refitted arrays back onto the plan so direct plan
        use (plan.execute / stats) sees the current geometry."""
        raise NotImplementedError


class SingleDeviceAdapter(PlanAdapter):
    def __init__(self, plan: SingleDevicePlan):
        self.plan = plan

    def positions(self) -> torch.Tensor:
        a = self.plan.inner.arrays
        out = torch.empty_like(a["src_sorted"])
        out[a["src_perm"]] = a["src_sorted"]
        return out

    @property
    def arrays(self) -> dict:
        return self.plan.inner.arrays

    def signature(self) -> Tuple:
        return _eval.plan_signature(self.plan.inner)

    def refit(self, arrays: dict, x) -> dict:
        return refit_single_arrays(arrays, x)

    def slack_fn(self) -> Callable:
        cfg = self.plan.config

        def slack(arrays):
            return refresh_slacks_single(arrays, theta=cfg.theta,
                                         space=cfg.space)

        return slack

    def force_fn(self) -> Callable:
        opts = self.plan.config.exec_opts(self.plan.kernel)
        params = self.plan.kernel_params

        def force(arrays, x, q, w):
            del x  # already refitted into arrays
            return _eval.potential_and_forces(arrays, q, w, params, **opts)

        return force

    @property
    def device_rebuild(self) -> bool:
        return self.plan.config.build_backend == "device"

    @property
    def supports_async_rebuild(self) -> bool:
        # the device pipeline, and a budget to dispatch fixed shapes into
        return self.device_rebuild and self.plan.capacities is not None

    def rebuild(self, x) -> bool:
        old_sig = self.signature()
        self.plan = self.plan.replan(x)   # keeps capacities, grows
        return self.signature() != old_sig

    def rebuild_dispatch(self, x):
        return self.plan.replan_async(x)

    def rebuild_commit(self, pending) -> Tuple[bool, float, bool]:
        old_sig = self.signature()
        plan, wait_ms, grew = pending.finalize()
        self.plan = plan
        return self.signature() != old_sig, wait_ms, grew

    def sync_arrays(self, arrays: dict) -> None:
        self.plan.inner.arrays = arrays


class ShardedAdapter(PlanAdapter):
    """Adapter over `ShardedPlan`. The rank tables (`rank_gather`,
    `input_pos`) ride in the `arrays` dict the engine threads through its
    step, so a rebuild swaps them with the plan's arrays. The force and
    slack closures read the budget's halo schedule, so a budget growth
    makes the engine re-close them (`recloses_on_rebuild`); `rebuild`
    reports exactly that. Rebuilds run on the host, whatever the local
    plans' `build_backend`."""

    recloses_on_rebuild = True
    _IO_KEYS = ("rank_gather", "input_pos")

    def __init__(self, plan: ShardedPlan):
        self.plan = plan

    def positions(self) -> torch.Tensor:
        plan, ranks = self.plan, self.plan.ranks
        src = ranks.all_gather(plan.arrays["src_sorted"])  # (P, per_pad, 3)
        perm = ranks.all_gather(plan.arrays["charges_perm"])
        rank_gather = ranks.all_gather(plan.rank_gather)
        # src_sorted[r, j] is slab point perm[r, j] of rank r, whose input
        # index is rank_gather[r, perm[r, j]]; real rows are the prefix
        valid = rank_gather >= 0
        idx = torch.gather(rank_gather, 1, perm)
        out = src.new_empty((plan.num_points, 3))
        out[idx[valid]] = src[valid]
        return out

    @property
    def arrays(self) -> dict:
        plan = self.plan
        return dict(plan.arrays, rank_gather=plan.rank_gather,
                    input_pos=plan.input_pos)

    def signature(self) -> Tuple:
        # widths change shapes, a halo-round change adds or removes keys
        return _eval.plan_signature(self.plan)

    def refit(self, arrays: dict, x) -> dict:
        return refit_sharded_arrays(arrays, x, self.plan.depth)

    def slack_fn(self) -> Callable:
        cfg, ranks = self.plan.config, self.plan.ranks

        def slack(arrays):
            return refresh_slacks_sharded(arrays, theta=cfg.theta,
                                          space=cfg.space, ranks=ranks)

        return slack

    def force_fn(self) -> Callable:
        opts = self.plan.exec_opts()
        params = self.plan.kernel_params

        def force(arrays, x, q, w):
            del x  # already refitted into arrays
            f = unrank(opts["ranks"], sharded_sweep(
                "field", arrays, stage_ranks(arrays["rank_gather"], q),
                params, **opts), arrays["input_pos"])
            return f[:, 0], -w[:, None] * f[:, 1:]

        return force

    def rebuild(self, x) -> bool:
        old_sig = self.signature()
        self.plan = self.plan.replan(x)   # keeps capacities, grows
        return self.signature() != old_sig

    def sync_arrays(self, arrays: dict) -> None:
        self.plan.arrays = {k: v for k, v in arrays.items()
                            if k not in self._IO_KEYS}


def make_adapter(plan) -> PlanAdapter:
    """Dispatch a plan to its dynamics adapter."""
    if isinstance(plan, SingleDevicePlan):
        return SingleDeviceAdapter(plan)
    if isinstance(plan, ShardedPlan):
        return ShardedAdapter(plan)
    raise TypeError(f"no dynamics adapter for {type(plan).__name__}")

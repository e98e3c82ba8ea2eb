"""Distributed BLTC: RCB domain decomposition and locally essential trees
(port of `repro/distributed/bltc.py`; Sec. 3.1).

The host builds everything, as the paper's CPU side does: RCB slabs
(`rcb.py`), one local plan per rank, and each rank's locally essential
tree (LET), i.e. the remote clusters and boundary leaves its targets need
from the other ranks' trees under the same space-aware MAC. The device
then runs, over a leading local-rank axis R:

    local q_hat (one ranged modified-charge call over the ranks' chunk
    tables)  ->  local approximation and direct lanes (one launch each
    for all R ranks)  ->  all-gather of node boxes and q_hat, remote
    approximation lane (one launch over the R*B batch rows against the
    gathered P*M grids)  ->  halo rounds of boundary leaves, halo direct
    lane (one launch for all R ranks)  ->  un-permutation.

The two collectives go through `exchange.py`: `StackedRanks` holds every
rank on the plan's one device (R = P), `GroupRanks` one rank per process
over a `torch.distributed` device mesh (R = 1). Every stacked array is
padded into one `core.eval.ShardedCapacities` budget, and the halo runs a
FIXED schedule of rounds, one per rank offset in the budget's range
(rounds a build does not need send only masked, count-0 leaves), so
builds in one budget have equal shapes: the MD rebuild path.

Differences from the reference, none in the result: q_hat comes from the
port's chunk table (`mc_chunks` / `mc_chunk_ptr` per rank), not from the
per-level buckets the reference's program reads (the buckets stay: the
sharded refit reads them); forces come from the field kernels in one
sweep, not three JVPs; halo leaves travel with their particle counts, so
the halo lane sweeps only real points. The reference's sharded program
passes none of ``precompute="hierarchical"``, ``kahan`` and
``approx_r2``; neither does the port's (direct q_hat, plain sums, the
difference form of r^2).

Build one with ``TreecodeSolver.plan(points, nranks=P)`` (stacked on the
solver's device) or ``plan(points, mesh=mesh)`` (one rank per process).
"""
from __future__ import annotations

import dataclasses
import time
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cheby
from repro_torch.core import eval as ceval
from repro_torch.core import interaction
from repro_torch.core.api import lift_params
from repro_torch.core.interaction import batch_half_extents, mac_accept
from repro_torch.core.potentials import Kernel
from repro_torch.core.tree import Tree
from repro_torch.distributed.exchange import StackedRanks
from repro_torch.distributed.rcb import RCB, rcb_partition
from repro_torch.kernels import ops
from repro_torch.lint import runtime as _rt
from repro_torch.obs import trace as _trace
from repro_torch.obs.occupancy import static_occupancy as _static_occ


def _traverse_remote(cfg, tree: Tree, bc, br, bhw):
    """Traverse one remote tree for one batch under the space-aware MAC.

    Yields ("approx", node, theta_margin, fold_margin) (raw margins) and
    ("direct", leaf_slots) events. One traversal drives both the
    remote-approx lists and the remote-direct (halo) lists so both apply
    identical acceptance (min-image distances, fold-free approximation).

    Verlet skin: remote pairs within the skin of the MAC boundary are
    DEMOTED to direct (their leaves enter the halo lists) instead of
    being dual-listed, so remote approx margins stay above the same slack
    floor as local ones and no halo leaf is needed only now and then."""
    npts = (cfg.degree + 1) ** 3
    space = cfg.space
    thr_theta = interaction.theta_drift_rate(cfg.theta) * 0.5 * cfg.skin
    thr_fold = interaction.fold_drift_rate() * 0.5 * cfg.skin
    stack = [0]
    while stack:
        node = stack.pop()
        d = bc - tree.center[node]
        chw = 0.5 * (tree.hi[node] - tree.lo[node])
        dist_ok, fold_ok, t_margin, f_margin = mac_accept(
            space, cfg.theta, d, br, tree.radius[node], bhw + chw)
        mac = dist_ok and fold_ok and npts < tree.count[node]
        if mac and t_margin > thr_theta and f_margin > thr_fold:
            yield ("approx", node, float(t_margin), float(f_margin))
        elif not mac and not tree.is_leaf[node] \
                and not (dist_ok and npts >= tree.count[node]):
            stack.extend(int(k) for k in tree.children[node] if k >= 0)
        else:  # leaf, small-but-separated cluster, or skin-demoted pair
            if tree.is_leaf[node]:
                slots = [int(tree.leaf_index[node])]
            else:
                slots = tree.leaves_in_range(
                    int(tree.start[node]),
                    int(tree.count[node])).tolist()
            yield ("direct", slots)


def _remote_lists(cfg, plans, nranks: int):
    """One cross-rank traversal pass: for every rank r, traverse every
    other rank s's tree with the same uniform MAC.

    Returns (approx, direct, halo_need, theta_slack, fold_slack):
      approx[r]:   [(batch, src rank, node)] remote approx accepts
      direct[r]:   [(batch, src rank, leaf slot)] remote direct hits
      halo_need:   {(src s, dst r): set(leaf slots)}, the halo traffic
      theta/fold_slack: min RAW margins over remote approx accepts (the
                   cross-rank part of the drift budgets; skin-demoted
                   pairs never enter the minima)."""
    approx: List[list] = [[] for _ in range(nranks)]
    direct: List[list] = [[] for _ in range(nranks)]
    halo_need: Dict[Tuple[int, int], set] = {}
    theta_slack = float("inf")
    fold_slack = float("inf")

    for r in range(nranks):
        batches = plans[r].batches
        bhw = batch_half_extents(batches)
        for s in range(nranks):
            if s == r:
                continue
            tree = plans[s].tree
            for b in range(batches.num_batches):
                for ev in _traverse_remote(cfg, tree, batches.center[b],
                                           batches.radius[b], bhw[b]):
                    if ev[0] == "approx":
                        _, node, t_margin, f_margin = ev
                        approx[r].append((b, s, node))
                        theta_slack = min(theta_slack, t_margin)
                        if np.isfinite(f_margin):
                            fold_slack = min(fold_slack, f_margin)
                    else:
                        halo_need.setdefault((s, r), set()).update(ev[1])
                        for sl in ev[1]:
                            direct[r].append((b, s, sl))
    return approx, direct, halo_need, theta_slack, fold_slack


def _rank_need(plans) -> dict:
    """Element-wise max of the per-rank single-device needs: the `rank`
    entry of the sharded needs dict (`ShardedCapacities.for_need`), the
    port's chunk-table budgets included."""
    dims = [ceval._plan_dims(pl) for pl in plans]
    need = {k: max(d[k] for d in dims)
            for k in ("num_batches", "batch_width", "num_leaves",
                      "leaf_width", "num_nodes", "approx_width",
                      "direct_width", "skin_direct_width", "depth",
                      "num_chunks", "num_leaf_chunks")}
    rows = [1] * need["depth"]
    widths = [1] * need["depth"]
    for d in dims:
        for i, v in enumerate(d["bucket_rows"]):
            rows[i] = max(rows[i], v)
        for i, v in enumerate(d["bucket_widths"]):
            widths[i] = max(widths[i], v)
    need["bucket_rows"] = tuple(rows)
    need["bucket_widths"] = tuple(widths)
    need["upward_rows"] = ()
    # device builds carry per-sparse-level row budgets; the ranks share
    # one depth, so the element-wise max aligns level for level
    for key in ("sparse_rows", "batch_sparse_rows"):
        tups = [d.get(key, ()) for d in dims]
        ln = max((len(t) for t in tups), default=0)
        need[key] = tuple(max((t[i] for t in tups if len(t) > i),
                              default=1) for i in range(ln))
    return need


def _max_per_batch(events_per_rank) -> int:
    """Widest per-(rank, batch) event list: a remote list width need."""
    w = 1
    for events in events_per_rank:
        counts: Dict[int, int] = {}
        for b, *_ in events:
            counts[b] = counts.get(b, 0) + 1
            w = max(w, counts[b])
    return w


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _pad2(arr: np.ndarray, shape: Tuple[int, ...], value) -> np.ndarray:
    pads = [(0, s - d) for s, d in zip(shape, arr.shape)]
    if any(p[1] < 0 for p in pads):
        raise ValueError(f"cannot pad {arr.shape} into {shape}")
    return np.pad(arr, pads + [(0, 0)] * (arr.ndim - len(shape)),
                  constant_values=value)


#: Stacked arrays the kernels read as interaction lists or chunk rows
#: (int32, their index type); every other integer array is int64, the
#: port's gather index type.
_INT32_KEYS = ("approx_idx", "direct_idx", "skin_direct", "skin_direct_node",
               "remote_approx_idx", "remote_direct_idx", "mc_chunks",
               "mc_chunk_ptr")


def _to_device(key: str, a: np.ndarray, dtype: torch.dtype, device):
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=dtype, device=device)
    if a.dtype == np.bool_ or a.dtype == np.uint8:
        return torch.as_tensor(a, device=device)
    it = np.int32 if key in _INT32_KEYS else np.int64
    return torch.as_tensor(np.ascontiguousarray(a, dtype=it), device=device)


# ---------------------------------------------------------------------------
# The sharded executor, over a leading local-rank axis R
# ---------------------------------------------------------------------------


#: The entry points of `kernels.ops` each sharded sweep calls, by lane:
#: the remote approximation lane is an approximation lane, the halo lane
#: a direct lane (`core.eval._LANE_OPS`).
LANE_OPS = {span: dict(ops_, remote_approx=ops_["approx"],
                       halo=ops_["direct"])
            for span, ops_ in ceval._LANE_OPS.items()}


def sharded_lane_inputs(arrays: dict, q_rank: torch.Tensor, *, ranks,
                        halo_offsets: Tuple[int, ...], degree: int,
                        space, backend: str = "auto", theta: float = 0.7,
                        skin: float = 0.0, grid_nodes: bool = False) -> dict:
    """The four lanes' kernel inputs of a sharded plan for the ranks'
    charge slabs q_rank (R, per_pad), as `sharded_sweep` feeds them:
    ``{lane: (idx, tgt, pts, q, counts)}`` for "approx", "direct",
    "remote_approx" and "halo", in the reference's sum order.

    The local lanes are `core.eval.lane_inputs` on the stacked rank
    arrays (one modified-charge call for all R ranks, Verlet-skin
    routing when skin > 0). The remote approximation lane takes the
    flattened (R*B) batch rows against the gathered (P*M) clusters, which
    `remote_approx_idx` indexes directly (a systems axis would offset
    them by rank). The halo lane takes the leaves the halo rounds
    delivered, each with its particle count: masked rounds and empty
    slots give count-0 leaves, which the kernels never sweep. With
    ``grid_nodes=True`` both approximation lanes carry each cluster's
    1-D Chebyshev nodes (C, 3, n+1), as the grid field kernel takes
    them."""
    lanes = ceval.lane_inputs(
        dict(arrays, src_perm=arrays["charges_perm"]), q_rank,
        degree=degree, space=space, backend=backend, theta=theta,
        skin=skin, grid_nodes=grid_nodes)
    tgt = arrays["tgt_batched"]
    out = {lane: (idx, tgt, pts, q, counts)
           for lane, (idx, pts, q, counts) in lanes.items()}
    _, _, qhat, cnt = lanes["approx"]
    tgt_count = cnt["tgt_count"]

    with _trace.span("sharded.all_gather"):
        g_lo = ranks.all_gather(arrays["node_lo"]).flatten(0, 1)
        g_hi = ranks.all_gather(arrays["node_hi"]).flatten(0, 1)
        g_qhat = ranks.all_gather(qhat).flatten(0, 1)
    g_pts = (ops._cluster_nodes(g_lo, g_hi, degree) if grid_nodes
             else cheby.cluster_grid(g_lo, g_hi, degree))
    out["remote_approx"] = (arrays["remote_approx_idx"].flatten(0, 1),
                            tgt.flatten(0, 1), g_pts, g_qhat,
                            {"tgt_count": tgt_count.flatten()})

    with _trace.span("sharded.halo_rounds"):
        _, leaf_pts, leaf_q, dcnt = lanes["direct"]
        recv: List[list] = [[], [], []]
        for i, off in enumerate(halo_offsets):
            send = arrays[f"halo_send_{i}"]               # (R, H) leaf slots
            safe, valid = send.clamp(min=0), send >= 0
            sent = (
                torch.where(valid[..., None, None],
                            ops.take(leaf_pts, safe, True), 0.0),
                torch.where(valid[..., None],
                            ops.take(leaf_q, safe, True), 0.0),
                torch.where(valid, ops.take(dcnt["src_count"], safe, True),
                            0))
            for acc, t in zip(recv, ranks.halo_round(sent, off)):
                acc.append(t)
        halo_pts, halo_q, halo_count = (torch.cat(a, dim=1) for a in recv)
    out["halo"] = (arrays["remote_direct_idx"], tgt, halo_pts, halo_q,
                   {"tgt_count": tgt_count, "src_count": halo_count})
    return out


def sharded_sweep(span: str, arrays: dict, q_rank: torch.Tensor, params, *,
                  kernel: Kernel, **opts) -> torch.Tensor:
    """The four lanes of a sharded plan, summed in the reference's order
    (local approximation, local direct, remote approximation, halo), per
    rank slab slot: (R, per_pad) potentials (``span="lane"``) or
    (R, per_pad, 4) phi and its gradient (``span="field"``). One launch
    per lane (`LANE_OPS[span]`); `opts` are `sharded_lane_inputs`'s."""
    lanes = sharded_lane_inputs(arrays, q_rank, grid_nodes=span == "field",
                                **opts)
    kw = dict(kernel=kernel, space=opts["space"],
              backend=opts.get("backend", "auto"))
    out = None
    for lane, (idx, tgt, pts, q, counts) in lanes.items():
        with _trace.span(f"eval.{lane}_{span}"):
            y = LANE_OPS[span][lane](idx, tgt, pts, q, params, **kw,
                                     **counts)
            _trace.sync(q_rank.device)
        out = y if out is None else out + y.view(out.shape)
    return ops.take(out.flatten(1, 2), arrays["gather_index"], True)


@dataclasses.dataclass
class ShardedPlan:
    """RCB + LET execution plan conforming to the solver protocol
    (`execute` / `potential_and_forces` / `stats` / `replan`)."""

    config: object                      # core.api.TreecodeConfig
    kernel: Kernel
    arrays: Dict[str, torch.Tensor]     # leading axis: the local ranks
    perm_rounds: Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]
    depth: int                          # bucket level count
    nranks: int
    rcb: RCB
    scratch_node: int                   # padded node row (zero q_hat)
    per_pad: int                        # common padded slab width
    num_points: int
    padding_waste: float                # mean over per-rank local plans
    dtype: torch.dtype
    ranks: object                       # exchange.StackedRanks | GroupRanks
    capacities: ceval.ShardedCapacities
    # Rank tables (shared with the dynamics adapter):
    #   rank_gather: (R, per_pad) input particle index per slab slot, -1 pad
    #   input_pos:   (N,) flat (rank * per_pad + slot) of each input index
    rank_gather: torch.Tensor
    input_pos: torch.Tensor
    kernel_params: tuple = ()
    # Min MAC slack over local AND remote approx lists: the drift budget
    # within which a topology-preserving refit keeps every list valid.
    mac_slack: float = float("inf")
    theta_slack: float = float("inf")
    fold_slack: float = float("inf")
    halo_rounds_active: int = 0
    # Host build wall time per stage (ms): rcb / local_plans /
    # let_traversal / pad / commit (the upload to the plan's device).
    build_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def num_targets(self) -> int:
        return self.num_points

    @property
    def num_sources(self) -> int:
        return self.num_points

    @property
    def space(self):
        return self.config.space

    @property
    def skin(self) -> float:
        """Verlet-skin radius the interaction lists were built with."""
        return self.config.skin

    @property
    def device(self) -> torch.device:
        return self.arrays["tgt_batched"].device

    # ------------------------------------------------------------------
    # host-side construction
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, points, cfg, nranks: int, *, ranks=None, device="cuda",
              kernel: Optional[Kernel] = None,
              capacities="auto") -> "ShardedPlan":
        """Host-side setup: RCB, per-rank local plans, cross-rank LET
        lists, and capacity padding of everything into one budget.

        `ranks`: where the ranks live (`exchange.StackedRanks(nranks)` by
        default). `capacities`: "auto" (default) budgets this build's own
        needs with headroom; an explicit `ShardedCapacities` (a previous
        plan's, via `replan`) is grown to fit and otherwise reused, so
        the arrays keep their shapes."""
        with _trace.span("plan.build_sharded"):
            return cls._build_impl(
                np.asarray(points), cfg, int(nranks),
                ranks=ranks or StackedRanks(nranks),
                device=torch.device(device), kernel=kernel,
                capacities=capacities)

    @classmethod
    def _build_impl(cls, points, cfg, nranks, *, ranks, device, kernel,
                    capacities):
        points = np.asarray(cfg.space.wrap(points))
        dtype = torch.float64 if points.dtype == np.float64 \
            else torch.float32
        build_ms: Dict[str, float] = {}
        _t = time.perf_counter()
        with _trace.span("plan.rcb"):
            rcb = rcb_partition(points, nranks)
        build_ms["rcb"] = (time.perf_counter() - _t) * 1e3

        _t = time.perf_counter()
        with _trace.span("plan.local_plans"):
            slabs = [points[rcb.perm[rcb.starts[r]:rcb.starts[r + 1]]]
                     for r in range(nranks)]
            kw = dict(theta=cfg.theta, degree=cfg.degree,
                      leaf_size=cfg.leaf_size,
                      batch_size=cfg.resolved_batch_size(),
                      space=cfg.space, skin=cfg.skin)
            if cfg.build_backend == "device":
                # Per-rank device builds with ONE dense-octree depth
                # (source and target) across ranks, so every rank's
                # budget has the same level structure and stacks.
                from repro_torch.devtree import build as _devtree
                d_src = max(_devtree.depth_for(len(s), cfg.leaf_size)
                            for s in slabs)
                d_tgt = max(
                    _devtree.depth_for(len(s), cfg.resolved_batch_size())
                    for s in slabs)
                plans = []
                for slab in slabs:
                    x = torch.as_tensor(slab, device=device)
                    plans.append(_devtree.prepare_plan_device(
                        x, x, depth=d_src, batch_depth=d_tgt, **kw))
            else:
                plans = [ceval.prepare_plan(slab, slab, device="cpu", **kw)
                         for slab in slabs]
        build_ms["local_plans"] = (time.perf_counter() - _t) * 1e3

        _t = time.perf_counter()
        with _trace.span("plan.let_traversal"):
            remote_approx, remote_direct, halo_need, r_theta, r_fold = \
                _remote_lists(cfg, plans, nranks)
        build_ms["let_traversal"] = (time.perf_counter() - _t) * 1e3
        theta_slack = min([r_theta] + [pl.theta_slack for pl in plans])
        fold_slack = min([r_fold] + [pl.fold_slack for pl in plans])
        mac_slack = interaction.scaled_mac_slack(cfg.theta, theta_slack,
                                                 fold_slack)

        # ---- the capacity budget from this build's needs
        need = dict(
            nranks=nranks,
            rank=_rank_need(plans),
            slab_width=rcb.max_count(),
            remote_approx_width=_max_per_batch(remote_approx),
            remote_direct_width=_max_per_batch(remote_direct),
            halo_offsets=tuple(sorted({r - s for (s, r) in halo_need})),
            halo_width=max([len(v) for v in halo_need.values()] + [1]),
        )
        if capacities is None or capacities == "auto":
            caps = ceval.ShardedCapacities.for_need(need)
        elif isinstance(capacities, ceval.ShardedCapacities):
            caps = capacities.grown_to_fit(need)
        else:
            raise TypeError(
                "sharded capacities must be 'auto' or a "
                "repro_torch.core.eval.ShardedCapacities, got "
                f"{type(capacities).__name__}")

        _t = time.perf_counter()
        with _trace.span("plan.pad"):
            arrays, perm_rounds, active = _stacked_arrays(
                plans, caps, nranks, remote_approx, remote_direct,
                halo_need)
            # rank tables (charge staging and the dynamics adapter)
            per_pad = caps.slab_width
            rank_gather = np.full((nranks, per_pad), -1, np.int64)
            input_pos = np.empty(points.shape[0], np.int64)
            for r in range(nranks):
                idx = rcb.perm[rcb.starts[r]:rcb.starts[r + 1]]
                rank_gather[r, :len(idx)] = idx
                input_pos[idx] = r * per_pad + np.arange(len(idx))
        build_ms["pad"] = (time.perf_counter() - _t) * 1e3

        _t = time.perf_counter()
        with _trace.span("plan.commit"):
            arrays = {k: _to_device(k, ranks.local(v), dtype, device)
                      for k, v in arrays.items()}
            rank_gather = torch.as_tensor(ranks.local(rank_gather),
                                          device=device)
            input_pos = torch.as_tensor(input_pos, device=device)
            _trace.sync(device)
        build_ms["commit"] = (time.perf_counter() - _t) * 1e3

        kernel = kernel or cfg.make_kernel()
        return cls(config=cfg, kernel=kernel, arrays=arrays,
                   perm_rounds=perm_rounds, depth=caps.rank.depth,
                   nranks=nranks, rcb=rcb, scratch_node=caps.scratch_node,
                   per_pad=per_pad, num_points=points.shape[0],
                   padding_waste=float(np.mean([pl.padding_waste
                                                for pl in plans])),
                   dtype=dtype, ranks=ranks, capacities=caps,
                   rank_gather=rank_gather, input_pos=input_pos,
                   kernel_params=lift_params(kernel, dtype, device),
                   mac_slack=mac_slack, theta_slack=theta_slack,
                   fold_slack=fold_slack, halo_rounds_active=active,
                   build_ms=build_ms)

    # ------------------------------------------------------------------
    # device execution
    # ------------------------------------------------------------------

    def exec_opts(self) -> dict:
        """Options of `sharded_sweep` (the kernel stripped of its
        defaults: parameter values travel as tensors)."""
        cfg = self.config
        return dict(ranks=self.ranks,
                    halo_offsets=self.capacities.halo_offsets,
                    degree=cfg.degree, kernel=self.kernel.stripped(),
                    space=cfg.space, backend=cfg.backend, theta=cfg.theta,
                    skin=cfg.skin)

    def _charges(self, charges) -> torch.Tensor:
        return torch.as_tensor(charges, dtype=self.dtype, device=self.device)

    def rank_charges(self, q: torch.Tensor) -> torch.Tensor:
        """(R, per_pad) rank slabs of the (N,) input-order `q` through the
        -1-padded gather table; padded slots carry exactly zero."""
        return stage_ranks(self.rank_gather, q)

    def _params(self, kernel_params) -> tuple:
        if kernel_params is None:
            return self.kernel_params
        p = self.kernel.normalize_params(kernel_params)
        return tuple(torch.as_tensor(v, dtype=self.dtype, device=self.device)
                     for v in p)

    def execute(self, charges, kernel_params=None) -> torch.Tensor:
        """Potentials at all points (input order) on the plan's device.
        `kernel_params` overrides the kernel parameter values for this
        call."""
        with _trace.span("eval.execute_sharded"):
            q_rank = self.rank_charges(self._charges(charges))
            phi = unrank(self.ranks, sharded_sweep(
                "lane", self.arrays, q_rank, self._params(kernel_params),
                **self.exec_opts()), self.input_pos)
            _trace.sync(self.device)
        return phi

    def potential_and_forces(self, charges, weights=None,
                             kernel_params=None):
        """(phi, F) with F_i = -w_i * grad_x phi(x_i), input order: the
        four lanes through the field kernels in one sweep. `weights`
        defaults to the charges (the physical force on charge q_i)."""
        q = self._charges(charges)
        w = q if weights is None else self._charges(weights)
        with _trace.span("eval.potential_and_forces_sharded"):
            f = unrank(self.ranks, sharded_sweep(
                "field", self.arrays, self.rank_charges(q),
                self._params(kernel_params), **self.exec_opts()),
                self.input_pos)
            _trace.sync(self.device)
        return f[:, 0], -w[:, None] * f[:, 1:]

    def stats(self) -> dict:
        """Geometry / cost / budget counters for the sharded strategy:
        rank balance, padded slab width, the fixed halo-round schedule
        (total rounds vs the rounds this build uses), padding waste, the
        build phases, static occupancy over this process's ranks and the
        full `ShardedCapacities` budget. Reads counts off the device
        arrays: call it outside timed loops."""
        counts = self.rcb.counts()
        caps = self.capacities
        first = self.ranks.first_rank
        local = counts[first:first + self.arrays["tgt_batched"].shape[0]]
        view = types.SimpleNamespace(arrays=self.arrays,
                                     num_targets=int(local.sum()))
        return dict(
            strategy="sharded",
            nranks=self.nranks,
            num_targets=self.num_points,
            num_sources=self.num_points,
            rank_counts=counts.tolist(),
            slab_pad=self.per_pad,
            halo_rounds=len(self.perm_rounds),
            halo_rounds_active=self.halo_rounds_active,
            padding_waste=self.padding_waste,
            dtype=str(self.dtype).replace("torch.", ""),
            space=repr(self.config.space),
            mac_slack=self.mac_slack,
            theta_slack=self.theta_slack,
            fold_slack=self.fold_slack,
            skin=self.config.skin,
            capacity_padded=True,
            build_phases=dict(self.build_ms),
            occupancy=_static_occ(view),
            capacities=dataclasses.asdict(caps),
        )

    def replan(self, targets, sources=None, *,
               capacities="keep") -> "ShardedPlan":
        """Rebuild geometry for moved particles under the same config,
        ranks and device.

        `capacities="keep"` (default) re-pads the new geometry into this
        plan's own budget (growing it geometrically if the new build no
        longer fits), so the rebuilt plan keeps every shape: the sharded
        MD rebuild path. "auto" re-budgets from the new build's needs;
        an explicit `ShardedCapacities` pads into that."""
        if sources is not None and sources is not targets:
            raise ValueError("sharded plans require targets == sources")
        if capacities == "keep":
            capacities = self.capacities
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        # the host build pulls the points and uploads the plan: a
        # sanctioned transfer inside a caller's no_implicit_syncs()
        with _rt.explicit_sync("host_build"):
            if isinstance(targets, torch.Tensor):
                targets = targets.detach().cpu().numpy()
            return ShardedPlan.build(
                np.asarray(targets, np_dtype), self.config, self.nranks,
                ranks=self.ranks, device=self.device, kernel=self.kernel,
                capacities=capacities)


def stage_ranks(rank_gather: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(R, per_pad) slabs of the (N,) input-order `q` through the -1-padded
    gather table; padded slots carry exactly zero."""
    return torch.where(rank_gather >= 0, q[rank_gather.clamp(min=0)],
                       torch.zeros((), dtype=q.dtype, device=q.device))


def unrank(ranks, per_rank: torch.Tensor, input_pos: torch.Tensor):
    """(R, per_pad, ...) rank-major results in input order (every rank's,
    all-gathered first when the ranks are processes)."""
    return ranks.all_gather(per_rank).flatten(0, 1)[input_pos]


def _stacked_arrays(plans, caps, nranks, remote_approx, remote_direct,
                    halo_need):
    """The stacked (P, ...) host arrays of a sharded plan, padded into
    `caps`, with the halo schedule. Returns (arrays, perm_rounds, the
    number of rounds this build uses)."""
    rc = caps.rank
    b_pad, nb_pad = rc.num_batches, rc.batch_width
    l_pad, nl_pad = rc.num_leaves, rc.leaf_width
    m_pad, scratch = rc.num_nodes, rc.scratch_node
    a_pad, d_pad = rc.approx_width, rc.direct_width
    sd_pad = rc.skin_direct_width
    per_pad = caps.slab_width

    # ---- halo schedule: the budget's FIXED rounds; the received slot of
    # each (s -> r) leaf indexes the round-major concatenated buffers
    halo_slot: Dict[Tuple[int, int], Dict[int, int]] = {}
    halo_send = []
    for i, off in enumerate(caps.halo_offsets):
        tbl = np.full((nranks, caps.halo_width), -1, np.int64)
        base = i * caps.halo_width
        for (s, r), slots in halo_need.items():
            if r - s != off:
                continue
            ordered = sorted(slots)
            tbl[s, :len(ordered)] = ordered
            halo_slot[(s, r)] = {slot: base + j
                                 for j, slot in enumerate(ordered)}
        halo_send.append(tbl)
    perm_rounds = tuple(
        (off, tuple((s, s + off) for s in range(nranks)
                    if 0 <= s + off < nranks))
        for off in caps.halo_offsets)

    def pad_events(events_per_rank, width, value_of):
        """(batch, ...) event lists -> (P, b_pad, width) -1-padded."""
        out = np.full((nranks, b_pad, width), -1, np.int64)
        fill = np.zeros((nranks, b_pad), np.int64)
        for r, events in enumerate(events_per_rank):
            for ev in events:
                b = ev[0]
                out[r, b, fill[r, b]] = value_of(r, ev)
                fill[r, b] += 1
        return out

    def stack(field, shape, value=0, recompute=None):
        outs = []
        for pl in plans:
            a = _np(pl.arrays[field])
            if recompute is not None:
                a = recompute(pl, a)
            outs.append(_pad2(a, shape, value))
        return np.stack(outs)

    def fix_gather_index(pl, gi):
        old_nb = pl.arrays["tgt_batched"].shape[1]
        return (gi // old_nb) * nb_pad + gi % old_nb

    arrays = {
        "src_sorted": stack("src_sorted", (per_pad, 3)),
        "charges_perm": stack("src_perm", (per_pad,)),
        "tgt_batched": stack("tgt_batched", (b_pad, nb_pad, 3)),
        "tgt_mask": stack("tgt_mask", (b_pad, nb_pad), value=False),
        "gather_index": stack("gather_index", (per_pad,),
                              recompute=fix_gather_index),
        "leaf_gather": stack("leaf_gather", (l_pad, nl_pad), value=-1),
        "node_lo": stack("node_lo", (m_pad, 3)),
        "node_hi": stack("node_hi", (m_pad, 3), value=1),
        "approx_idx": stack("approx_idx", (b_pad, a_pad), value=-1),
        "direct_idx": stack("direct_idx", (b_pad, d_pad), value=-1),
        "approx_skin": stack("approx_skin", (b_pad, a_pad), value=0),
        "skin_direct": stack("skin_direct", (b_pad, sd_pad), value=-1),
        "skin_direct_node": stack("skin_direct_node", (b_pad, sd_pad),
                                  value=-1),
        "remote_approx_idx": pad_events(
            remote_approx, caps.remote_approx_width,
            lambda r, ev: ev[1] * m_pad + ev[2]),
        "remote_direct_idx": pad_events(
            remote_direct, caps.remote_direct_width,
            lambda r, ev: halo_slot[(ev[1], r)][ev[2]]),
    }
    # the port's chunk table of the modified charges, per rank: the
    # pointer repeats its last value over padded nodes, padded rows are
    # empty ranges of the scratch node
    chunks = np.zeros((nranks, rc.num_chunks, 3), np.int64)
    chunks[:, :, 0] = scratch
    ptr = np.zeros((nranks, m_pad + 1), np.int64)
    for r, pl in enumerate(plans):
        c, p = _np(pl.arrays["mc_chunks"]), _np(pl.arrays["mc_chunk_ptr"])
        chunks[r, :len(c)] = c
        ptr[r, :len(p)] = p
        ptr[r, len(p):] = p[-1]
    arrays["mc_chunks"], arrays["mc_chunk_ptr"] = chunks, ptr
    for lvl in range(rc.depth):
        shape = (rc.bucket_rows[lvl], rc.bucket_widths[lvl])
        gs, ns = [], []
        for pl in plans:
            bg, bn = pl.arrays["bucket_gather"], pl.arrays["bucket_nodes"]
            if lvl < len(bg):
                gs.append(_pad2(_np(bg[lvl]), shape, -1))
                ns.append(_pad2(_np(bn[lvl]), shape[:1], scratch))
            else:
                gs.append(np.full(shape, -1, np.int64))
                ns.append(np.full(shape[:1], scratch, np.int64))
        arrays[f"bucket_gather_{lvl}"] = np.stack(gs)
        arrays[f"bucket_nodes_{lvl}"] = np.stack(ns)
    for i, tbl in enumerate(halo_send):
        arrays[f"halo_send_{i}"] = tbl
    active = sum(1 for tbl in halo_send if (tbl >= 0).any())
    return arrays, perm_rounds, active

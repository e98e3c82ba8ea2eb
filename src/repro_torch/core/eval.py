"""Device evaluation pipeline: plan (host) -> execute (device).

PyTorch port of the single-device path of `repro/core/eval.py`. The host
packs the tree, batches and interaction lists into static padded arrays
once (`prepare_plan`); `execute` then computes

    modified charges (one ranged launch over every node)  ->  cluster
    Chebyshev grids  ->  approximation lane over the approx lists  ->
    direct lane over the leaf lists  ->  un-permutation back to input
    order.

`potential_and_gradient` and `potential_and_forces` run the same
pipeline with the field kernel in both lanes: phi and grad_x phi in one
sweep (the reference takes three forward JVPs through its executor).

The packing is NumPy and identical to the reference's, so the same
points give the same plan arrays; `arrays_from_numpy` moves them onto
the plan's device. It also takes a reference plan's arrays (pulled to
NumPy), which is how the tests run both packages on one plan.

Capacity padding (`Capacities`, `pad_plan`, `plan_signature`) re-pads a
plan into a fixed budget so MD replans keep every array shape. Point
budgets (`Capacities.num_targets` / `num_sources`) pad the particle axes
too, so plans over different particle counts share every shape: the
ensemble setting of `repro_torch.serve`, whose executors
(`ensemble_execute`, `ensemble_potential_and_forces`) run the same
pipeline over stacked plan arrays with a leading systems axis, one
launch per kernel for all systems.

`differentiable_execute` is `execute` with a backward: the target
cotangent from the field sweep, the charge cotangent from the transposed
pass (the batch-cluster kernel with the roles swapped over the
transposed lists, then the modified charges transposed).

``precompute="hierarchical"`` (`compute_qhat_hierarchical`) takes the
leaves' modified charges from their particles and every internal
cluster's from its children; `add_hierarchical_tables` adds the tables
it reads. Plans built on the device (`repro_torch.devtree`) carry the
same arrays, built there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import cheby
from repro_torch.core.interaction import build_interaction_lists
from repro_torch.core.potentials import Kernel
from repro_torch.core.space import FREE as _FREE
from repro_torch.core.tree import Batches, Tree, build_batches, build_tree
from repro_torch.kernels import ops
from repro_torch.kernels.modified_charges import chunk_table, tile_table
from repro_torch.kernels.ops import take as _take
from repro_torch.lint import runtime as _rt
from repro_torch.obs import events as _events
from repro_torch.obs import trace as _trace


def _round_up(x: int, base: int = 8) -> int:
    return max(base, -(-x // base) * base)


def _round_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(x, 1)))))


# Plan arrays the executor indexes with (torch gathers take int64); the
# interaction lists stay int32, the CUDA kernel's index type.
_INDEX_KEYS = ("src_perm", "gather_index", "leaf_gather", "bucket_gather",
               "bucket_nodes", "parent_of", "upward_pairs",
               "upward_children")
#: The modified-charge chunk table `arrays_from_numpy` adds (int32).
CHUNK_KEYS = ("mc_chunks", "mc_chunk_ptr")
#: The hierarchical precompute's chunk table over the leaves' ranges only
#: (`add_hierarchical_tables`; int32, the layout of `CHUNK_KEYS`).
LEAF_CHUNK_KEYS = ("mc_leaf_chunks", "mc_leaf_chunk_ptr")


@dataclasses.dataclass
class Plan:
    """Geometry-dependent, charge-independent device arrays + host trees."""

    arrays: dict                 # tensors on `device`, consumed by `execute`
    tree: Tree                   # host copies for diagnostics
    batches: Batches
    padding_waste: float         # sentinel-slot fraction of kernel work
    num_targets: int
    num_sources: int
    mac_slack: float = float("inf")
    theta_slack: float = float("inf")
    fold_slack: float = float("inf")
    skin: float = 0.0
    # When capacity-padded (see `Capacities`), the capacities the arrays
    # were padded to, and the scratch node row absorbing sentinel writes.
    capacities: "Capacities | None" = None
    scratch_node: int = -1
    # Build-phase wall times in ms (host: tree_build / interaction_lists /
    # pack / pad; device: morton / needs / build / lists / assemble),
    # surfaced via plan.stats().
    build_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Which builder made the plan ("host" | "device") and, for a device
    # build, the `repro_torch.devtree` metadata behind the lazy
    # `tree` / `batches` proxies (the synced needs, the octree depths and
    # the traversal budgets `replan` keeps).
    build_backend: str = "host"
    dev: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.arrays["tgt_batched"].device


def arrays_from_numpy(arrays: dict, *, device, dtype) -> dict:
    """The port's plan arrays from NumPy plan arrays.

    `arrays` is a packed plan dict of NumPy arrays (tuples of per-level
    buckets included), from this module's packing or from a reference
    plan's arrays. Floating arrays become `dtype`, index tables int64,
    interaction lists int32, masks bool/uint8, all on `device`. The
    modified charges' chunk table (`CHUNK_KEYS`) is derived here from
    the per-level buckets, once per plan."""
    device = torch.device(device)
    arrays = dict(arrays)
    arrays.update(zip(CHUNK_KEYS, chunk_table(*node_ranges(arrays))))

    def one(key, a):
        a = np.asarray(a)
        if not a.flags.writeable:   # e.g. a view of a jax array
            a = a.copy()
        if np.issubdtype(a.dtype, np.floating):
            return torch.as_tensor(a, dtype=dtype, device=device)
        if key in _INDEX_KEYS:
            return torch.as_tensor(a.astype(np.int64), device=device)
        if a.dtype == np.bool_ or a.dtype == np.uint8:
            return torch.as_tensor(a, device=device)
        return torch.as_tensor(a.astype(np.int32), device=device)

    out = {}
    for key, a in arrays.items():
        if isinstance(a, (tuple, list)):
            out[key] = tuple(one(key, x) for x in a)
        else:
            out[key] = one(key, a)
    return out


def node_ranges(arrays: dict):
    """(start, count) int64 of every node's particle range in tree order.

    Each bucket row of a packed plan is the range table of one node, so
    start = g[:, 0] and count = (g >= 0).sum(1); a node in no bucket
    keeps count 0."""
    num_nodes = np.asarray(arrays["node_lo"]).shape[0]
    start = np.zeros(num_nodes, np.int64)
    count = np.zeros(num_nodes, np.int64)
    for g, nodes in zip(arrays["bucket_gather"], arrays["bucket_nodes"]):
        g, nodes = np.asarray(g), np.asarray(nodes)
        count[nodes] = (g >= 0).sum(1)
        start[nodes] = np.maximum(g[:, 0], 0)
    return start, count


def prepare_plan(
    targets: np.ndarray,
    sources: np.ndarray,
    *,
    theta: float,
    degree: int,
    leaf_size: int,
    batch_size: int,
    space=_FREE,
    skin: float = 0.0,
    device="cuda",
) -> Plan:
    """Host-side setup phase (tree build + traversal + packing).

    With a periodic `space`, coordinates are wrapped into the primary
    cell before the tree/batch build and the MAC traversal uses
    minimum-image center distances with the fold-free acceptance
    condition. `skin` is the Verlet-skin radius: pairs within the skin
    of the MAC boundary are dual-listed and gated by current distance at
    evaluation time. The packed arrays land on `device`."""
    with _trace.span("plan.build"):
        return _prepare_plan_timed(
            targets, sources, theta=theta, degree=degree,
            leaf_size=leaf_size, batch_size=batch_size, space=space,
            skin=skin, device=device)


def _prepare_plan_timed(targets, sources, *, theta, degree, leaf_size,
                        batch_size, space, skin, device):
    build_ms: Dict[str, float] = {}
    targets = np.asarray(space.wrap(np.asarray(targets)))
    sources = np.asarray(space.wrap(np.asarray(sources)))
    dtype = targets.dtype

    t0 = time.perf_counter()
    with _trace.span("plan.tree_build"):
        tree = build_tree(sources, leaf_size)
        batches = build_batches(targets, batch_size)
    t1 = time.perf_counter()
    build_ms["tree_build"] = (t1 - t0) * 1e3
    with _trace.span("plan.interaction_lists"):
        lists = build_interaction_lists(tree, batches, theta, degree, space,
                                        skin=skin)
    t2 = time.perf_counter()
    build_ms["interaction_lists"] = (t2 - t1) * 1e3

    with _trace.span("plan.pack"):
        arrays = _pack(targets, sources, tree, batches, lists, dtype)
        arrays = arrays_from_numpy(
            arrays, device=device,
            dtype=torch.float64 if dtype == np.float64 else torch.float32)
        _trace.sync(device)
    build_ms["pack"] = (time.perf_counter() - t2) * 1e3
    return Plan(
        arrays=arrays, tree=tree, batches=batches,
        padding_waste=float(lists.padding_waste),
        num_targets=targets.shape[0], num_sources=sources.shape[0],
        mac_slack=float(lists.mac_slack),
        theta_slack=float(lists.theta_slack),
        fold_slack=float(lists.fold_slack),
        skin=float(skin), build_ms=build_ms,
    )


#: Children of a node at most (`Tree.children` is (M, 8)): the width of
#: the upward pass's ``upward_children`` rows.
MAX_CHILDREN = 8


def _children_rows(parents: np.ndarray) -> np.ndarray:
    """(P, MAX_CHILDREN) int64 over one level's pairs: on each parent's
    first pair, the rows of that parent's pairs in pair order; -1 after
    them and on every other row."""
    order = np.argsort(parents, kind="stable")
    p = parents[order]
    first = np.ones(len(p), dtype=bool)
    first[1:] = p[1:] != p[:-1]
    seg = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    rank = np.arange(len(p)) - starts[seg]
    out = np.full((len(p), MAX_CHILDREN), -1, np.int64)
    out[order[starts[seg]], rank] = order
    return out


def add_hierarchical_tables(plan: Plan) -> Plan:
    """The plan with the hierarchical precompute's tables (a new Plan;
    call it before padding, on a host-built plan):

    - ``upward_pairs``: per level, deepest first, the (parent, child)
      node pairs (int64);
    - ``upward_children``: per level, each parent's children as rows of
      that level's pairs (`_children_rows`), so the upward pass sums
      them in a fixed order;
    - ``mc_leaf_chunks`` / ``mc_leaf_chunk_ptr``: the chunk table of the
      leaves' particle ranges over every node (internal nodes own no
      chunk), which the leaves' modified charges sweep. The reference
      keeps the leaves' node ids (``leaf_node_ids``) instead: its leaf
      pass gathers padded particle blocks, the port's is ranged."""
    tree = plan.tree
    device = plan.device
    pairs, children = [], []
    for lvl in range(int(tree.level.max()), 0, -1):
        nodes = np.nonzero(tree.level == lvl)[0]
        if len(nodes) == 0:
            continue
        parents = tree.parent[nodes]
        pairs.append(torch.as_tensor(np.stack([parents, nodes], axis=1),
                                     dtype=torch.int64, device=device))
        children.append(torch.as_tensor(_children_rows(parents),
                                        device=device))
    start = np.zeros(tree.num_nodes, np.int64)
    count = np.zeros(tree.num_nodes, np.int64)
    start[tree.leaf_ids] = tree.start[tree.leaf_ids]
    count[tree.leaf_ids] = tree.count[tree.leaf_ids]
    arrays = dict(plan.arrays, upward_pairs=tuple(pairs),
                  upward_children=tuple(children))
    arrays.update(zip(LEAF_CHUNK_KEYS, (
        torch.as_tensor(a, device=device) for a in chunk_table(start,
                                                               count))))
    return dataclasses.replace(plan, arrays=arrays)


def _pack(targets, sources, tree, batches, lists, dtype) -> dict:
    """The reference's packing, in NumPy: -1-padded lists and gather
    tables, the batch-packed target slab and the per-level buckets."""
    nb_pad = _round_up(batches.max_count)
    nl_pad = _round_up(tree.max_leaf_count)
    a_pad = _round_up(lists.approx.shape[1])
    d_pad = _round_up(lists.direct.shape[1])
    sd_pad = _round_up(lists.skin_direct.shape[1])

    def _pad_cols(a, width):
        return np.pad(a, ((0, 0), (0, width - a.shape[1])),
                      constant_values=-1)

    approx_idx = _pad_cols(lists.approx, a_pad).astype(np.int32)
    direct_idx = _pad_cols(lists.direct, d_pad).astype(np.int32)
    approx_skin = np.pad(
        lists.approx_skin, ((0, 0), (0, a_pad - lists.approx_skin.shape[1])),
        constant_values=0).astype(np.uint8)
    skin_direct = _pad_cols(lists.skin_direct, sd_pad).astype(np.int32)
    skin_direct_node = _pad_cols(lists.skin_direct_node,
                                 sd_pad).astype(np.int32)

    def _range_table(starts, counts, width, fill=-1):
        """(rows, width) table of [start, start+count) runs, `fill`-padded."""
        ar = np.arange(width, dtype=np.int64)
        return np.where(ar[None, :] < counts[:, None],
                        starts[:, None] + ar[None, :], fill)

    # Targets packed batch-contiguously, padded per row.
    nb = batches.num_batches
    tgt_sorted = targets[batches.perm]
    b_counts = batches.count.astype(np.int64)
    rows = np.repeat(np.arange(nb, dtype=np.int64), b_counts)
    within = np.arange(targets.shape[0]) - np.repeat(
        batches.start.astype(np.int64), b_counts)
    tgt_b = np.zeros((nb, nb_pad, 3), dtype)
    tgt_mask = np.zeros((nb, nb_pad), bool)
    tgt_b[rows, within] = tgt_sorted
    tgt_mask[rows, within] = True
    pos_of_batchorder = rows * nb_pad + within
    # phi_input[j] = phi_flat[gather_index[j]] for input target index j.
    inv_perm = np.argsort(batches.perm, kind="stable")
    gather_index = pos_of_batchorder[inv_perm].astype(np.int32)

    leaf_gather = _range_table(tree.start[tree.leaf_ids],
                               tree.count[tree.leaf_ids], nl_pad)

    # Per-level cluster buckets (the reference's packing, padded particle
    # counts rounded up to powers of two); the executor reads them only
    # through the chunk table `arrays_from_numpy` derives.
    bucket_gather, bucket_nodes = [], []
    for node_ids in tree.levels():
        m_pad = _round_pow2(int(tree.count[node_ids].max()))
        g = _range_table(tree.start[node_ids], tree.count[node_ids], m_pad)
        bucket_gather.append(g.astype(np.int32))
        bucket_nodes.append(node_ids.astype(np.int32))

    return dict(
        src_sorted=sources[tree.perm],
        src_perm=tree.perm.astype(np.int32),
        tgt_batched=tgt_b,
        gather_index=gather_index,
        leaf_gather=leaf_gather.astype(np.int32),
        node_lo=tree.lo.astype(dtype),
        node_hi=tree.hi.astype(dtype),
        approx_idx=approx_idx,
        direct_idx=direct_idx,
        approx_skin=approx_skin,
        skin_direct=skin_direct,
        skin_direct_node=skin_direct_node,
        tgt_mask=tgt_mask,
        bucket_gather=tuple(bucket_gather),
        bucket_nodes=tuple(bucket_nodes),
        parent_of=tree.parent.astype(np.int32),
    )


def stacked(arrays: dict) -> bool:
    """True for an ensemble's stacked plan arrays (a leading systems axis
    on every array), False for one plan's."""
    return arrays["node_lo"].dim() == 3


def _gathered(src_sorted, q_sorted, gather, st: bool = False):
    """(rows, pad, 3) points and (rows, pad) charges from a -1-padded
    gather table; padded slots hold the origin and charge 0 (``st``: a
    leading systems axis on all three)."""
    valid = gather >= 0
    safe = gather.clamp(min=0)
    zero = torch.zeros((), dtype=src_sorted.dtype, device=src_sorted.device)
    pts = torch.where(valid[..., None], _take(src_sorted, safe, st), zero)
    q = torch.where(valid, _take(q_sorted, safe, st), zero)
    return pts, q


@dataclasses.dataclass
class KernelInputs:
    """What the executor feeds the kernels for one charge vector, apart
    from q_hat (which the modified-charge kernel computes from `q_sorted`
    and the plan's chunk table) and the interaction lists."""

    q_sorted: torch.Tensor    # (N,) charges in tree order
    grids: Optional[torch.Tensor]  # (num_nodes, (n+1)^3, 3) grids, or None
    leaf_pts: torch.Tensor    # (num_leaves, nl_pad, 3)
    leaf_q: torch.Tensor      # (num_leaves, nl_pad)
    # prefix lengths of the kernels' count contract (int32): real targets
    # of each batch row, real particles of each leaf
    tgt_count: torch.Tensor   # (B,)
    leaf_count: torch.Tensor  # (num_leaves,)


def kernel_inputs(arrays: dict, charges: torch.Tensor, *, degree: int,
                  grids: bool = True) -> KernelInputs:
    """Gather the kernels' inputs from the plan arrays and `charges`
    (``grids=False``: no Chebyshev grid points, for the grid field kernel).

    The packing fills batch rows and leaves from slot 0, so the counts are
    the prefix lengths the batch-cluster kernel sweeps. Stacked arrays
    and charges (W, N) give every input with a leading systems axis."""
    st = stacked(arrays)
    q_sorted = _take(charges, arrays["src_perm"], st)
    leaf_pts, leaf_q = _gathered(arrays["src_sorted"], q_sorted,
                                 arrays["leaf_gather"], st)
    return KernelInputs(
        q_sorted=q_sorted,
        grids=(cheby.cluster_grid(arrays["node_lo"], arrays["node_hi"],
                                  degree) if grids else None),
        leaf_pts=leaf_pts, leaf_q=leaf_q,
        tgt_count=arrays["tgt_mask"].sum(-1, dtype=torch.int32),
        leaf_count=(arrays["leaf_gather"] >= 0).sum(-1, dtype=torch.int32))


def compute_qhat_direct(arrays, q_sorted, *, degree, backend):
    """Paper-faithful q_hat: every cluster from its own particles (Eq. 12),
    one ranged modified-charge call over every node's particle range."""
    return ops.modified_charges_ranged(
        arrays["src_sorted"], q_sorted, arrays["mc_chunks"],
        arrays["mc_chunk_ptr"], arrays["node_lo"], arrays["node_hi"],
        degree=degree, backend=backend)


def compute_qhat_hierarchical(arrays, q_sorted, *, degree, backend):
    """Upward-pass q_hat (beyond the paper, exact).

    The leaves' from their particles (one ranged modified-charge call
    over the leaves' chunk table, `LEAF_CHUNK_KEYS`; every other node
    comes out 0); every internal cluster's from its children by
    barycentric Chebyshev-to-Chebyshev restriction, deepest level first.
    L^parent_k is a degree-n polynomial per dimension, so interpolating
    it on the child grid is exact:

        qhat_p[k] = sum_child sum_k' (prod_l L^p_{k_l}(s^c_{k'_l})) qhat_c[k'].

    Cost O((n+1)^3 N) for the leaves + O(nodes (n+1)^4) for the pass.
    Stacked arrays run the pass for every system at once."""
    st = stacked(arrays)
    lo, hi = arrays["node_lo"], arrays["node_hi"]
    chunks, ptr = (arrays[k] for k in LEAF_CHUNK_KEYS)
    qhat = ops.modified_charges_ranged(
        arrays["src_sorted"], q_sorted, chunks, ptr, lo, hi, degree=degree,
        backend=backend)
    n1 = degree + 1
    for pairs, kids in zip(arrays["upward_pairs"],
                           arrays["upward_children"]):  # deepest first
        parents, children = pairs[..., 0], pairs[..., 1]
        rows = _restriction_rows(lo, hi, parents, children, degree, st)
        qc = _take(qhat, children, st).reshape(
            children.shape + (n1, n1, n1))
        contrib = torch.einsum("...pxa,...pyb,...pzc,...pxyz->...pabc",
                               rows[0], rows[1], rows[2], qc)
        # each parent's children summed in pair order on its first pair's
        # row (-1 picks the zero row put last), the other rows 0: every
        # parent gets one nonzero sum onto its 0, so the add is exact in
        # any order (no float atomics decide the result on the card)
        contrib = contrib.reshape(contrib.shape[:-3] + (n1 ** 3,))
        padded = torch.cat([contrib, contrib.new_zeros(
            contrib.shape[:-2] + (1, n1 ** 3))], dim=-2)
        last = padded.shape[-2] - 1
        summed = _take(padded, torch.where(kids >= 0, kids, last),
                       st).sum(-2)
        # every system's rows at once, in the flattened table
        off = (torch.arange(qhat.shape[0], device=parents.device)[:, None]
               * qhat.shape[1]) if st else 0
        qhat.view(-1, n1 ** 3).index_add_(
            0, (parents + off).flatten(), summed.reshape(-1, n1 ** 3))
    return qhat


def _restriction_rows(lo, hi, parents, children, degree, st):
    """Per axis, the restriction's rows L^parent_k(s^child_k') of every
    (parent, child) pair, (P, n+1 child, n+1 parent): the upward pass's
    matrices, and transposed its downward pass's."""
    dt, dev = lo.dtype, lo.device
    w = cheby.bary_weights_1d(degree, dt, dev)
    s01 = cheby.cheb_points_1d(degree, dt, dev)
    eps = torch.finfo(dt).eps
    p_lo, p_hi = _take(lo, parents, st), _take(hi, parents, st)
    c_lo, c_hi = _take(lo, children, st), _take(hi, children, st)
    rows = []
    for ax in range(3):
        child_nodes = cheby.map_points(
            s01, c_lo[..., ax:ax + 1], c_hi[..., ax:ax + 1])
        parent_nodes = cheby.map_points(
            s01, p_lo[..., ax:ax + 1], p_hi[..., ax:ax + 1])
        # child grids share corners with the parent box up to
        # rounding: a hit within ~64 ulp of the span
        tol = (64.0 * eps) * (p_hi[..., ax] - p_lo[..., ax])
        t, den = cheby.bary_terms(child_nodes, parent_nodes[..., None, :], w,
                                  tol=tol[..., None, None])
        rows.append(t / den[..., None])
    return rows


_QHAT = {"direct": compute_qhat_direct,
         "hierarchical": compute_qhat_hierarchical}


def _skin_routed_lists(arrays: dict, theta: float, space):
    """Current-distance routing of the Verlet-skin dual lists.

    Re-tests every skin pair's MAC on the current geometry and masks the
    losing side to the -1 sentinel the kernels skip: the approx slot
    while the MAC fails, the skin-direct slots while it holds. Returns
    the effective (approx_idx, direct_idx), the gated skin-direct slots
    appended to the static direct list."""
    bc, bhw, rb, has = ops.batch_boxes(arrays["tgt_batched"],
                                       arrays["tgt_mask"])
    gate_kw = dict(theta=theta, space=space)
    approx_idx = arrays["approx_idx"]
    gate_a = ops.mac_gate(approx_idx, bc, bhw, rb, has,
                          arrays["node_lo"], arrays["node_hi"], **gate_kw)
    sentinel = torch.full_like(approx_idx, -1)
    approx_idx = torch.where((arrays["approx_skin"] != 0) & ~gate_a,
                             sentinel, approx_idx)
    gate_d = ops.mac_gate(arrays["skin_direct_node"], bc, bhw, rb, has,
                          arrays["node_lo"], arrays["node_hi"], **gate_kw)
    skin_direct = torch.where(gate_d, torch.full_like(gate_d, -1,
                                                      dtype=torch.int32),
                              arrays["skin_direct"])
    direct_idx = torch.cat([arrays["direct_idx"], skin_direct], dim=-1)
    return approx_idx, direct_idx


def routed_lists(arrays: dict, *, theta: float = 0.7, space=_FREE,
                 skin: float = 0.0):
    """(approx_idx, direct_idx) the lanes sweep: the plan's lists, or with
    ``skin > 0`` the Verlet-skin dual lists routed by the runtime MAC gate
    on the current target slab (`_skin_routed_lists`)."""
    if skin > 0.0:
        return _skin_routed_lists(arrays, theta, space)
    return arrays["approx_idx"], arrays["direct_idx"]


def lane_inputs(arrays: dict, charges: torch.Tensor, *, degree: int,
                space=_FREE, backend: str = "auto", theta: float = 0.7,
                skin: float = 0.0, grid_nodes: bool = False,
                precompute: str = "direct", lists=None) -> dict:
    """The two lanes' kernel inputs for `charges`, as the executor feeds
    them: ``{"approx": (idx, pts, q, counts), "direct": (...)}``.

    One modified-charge call (`precompute` "direct" or "hierarchical",
    whose tables the plan must hold). The lists are `lists` (routed
    before, as the differentiable executor's backward passes the
    forward's), else `routed_lists` of the plan. Both lanes pass the batch
    rows' target counts; the direct lane (skin-routed slots included,
    which are leaf ids too) also the leaves' particle counts, while every
    Chebyshev grid is all real points. With ``grid_nodes=True`` the
    approximation lane carries each cluster's 1-D Chebyshev nodes
    (C, 3, n+1) in place of its grid points, as
    `ops.batch_cluster_field_grid` takes them (q_hat is k3 fastest
    either way). `chip_smoke.py` holds the kernels against their plain
    versions on these very tensors."""
    if precompute not in _QHAT:
        raise ValueError(f"unknown precompute {precompute!r}")
    inp = kernel_inputs(arrays, charges, degree=degree, grids=not grid_nodes)
    with _trace.span("eval.modified_charges"):
        qhat = _QHAT[precompute](arrays, inp.q_sorted, degree=degree,
                                 backend=backend)
        _trace.sync(charges.device)
    if lists is None:
        lists = routed_lists(arrays, theta=theta, space=space, skin=skin)
    approx_idx, direct_idx = lists
    pts = (ops._cluster_nodes(arrays["node_lo"], arrays["node_hi"], degree)
           if grid_nodes else inp.grids)
    return {"approx": (approx_idx, pts, qhat, {"tgt_count": inp.tgt_count}),
            "direct": (direct_idx, inp.leaf_pts, inp.leaf_q,
                       {"tgt_count": inp.tgt_count,
                        "src_count": inp.leaf_count})}


#: The entry points of `kernels.ops` each sweep calls, by lane: the
#: potential takes both lanes as explicit points; the field takes the
#: approximation lane as Chebyshev grids in factored form (the grid field
#: kernel) and the direct lane as points (the generic field kernel).
_LANE_OPS = {
    "lane": {"approx": ops.batch_cluster_eval,
             "direct": ops.batch_cluster_eval},
    "field": {"approx": ops.batch_cluster_field_grid,
              "direct": ops.batch_cluster_field},
}


def _sweep(span: str, arrays: dict, charges: torch.Tensor, params, *,
           degree: int, kernel: Kernel, space=_FREE, backend: str = "auto",
           kahan: bool = False, approx_r2: str = "diff", theta: float = 0.7,
           skin: float = 0.0, precompute: str = "direct",
           lists=None) -> torch.Tensor:
    """The `_LANE_OPS[span]` entry points over both lanes, summed and
    gathered back to the caller's input order (`lists`: the routed lists,
    as `lane_inputs` takes them)."""
    field = span == "field"
    lanes = lane_inputs(arrays, charges, degree=degree, space=space,
                        backend=backend, theta=theta, skin=skin,
                        grid_nodes=field, precompute=precompute, lists=lists)
    out = None
    for lane, (idx, pts, q, counts) in lanes.items():
        if lane == "approx" and not field:
            counts = dict(counts, r2_mode=approx_r2)
        with _trace.span(f"eval.{lane}_{span}"):
            try:
                y = _LANE_OPS[span][lane](
                    idx, arrays["tgt_batched"], pts, q, params,
                    kernel=kernel, space=space, backend=backend,
                    kahan=kahan, **counts)
            except FloatingPointError as e:   # REPRO_DEBUG_NANS
                raise FloatingPointError(f"{e} ({lane} lane)") from None
            _trace.sync(charges.device)
        out = y if out is None else out + y
    st = stacked(arrays)
    return _take(out.flatten(int(st), int(st) + 1), arrays["gather_index"], st)


def _execute_impl(arrays: dict, charges: torch.Tensor, params=None,
                  **opts) -> torch.Tensor:
    """Potentials at the plan's targets, in the caller's input order.

    `charges` lives on the plan's device. `params` carries kernel
    parameter values (tensors on the device, or None for the kernel's
    defaults). `opts` are `_sweep`'s: degree, kernel, space, backend,
    kahan, approx_r2, theta, skin and precompute."""
    return _sweep("lane", arrays, charges, params, **opts)


#: The executor. PyTorch runs eagerly, so there is no jitted twin: the
#: reference's `execute = jax.jit(_execute_impl, ...)` is the function.
execute = _execute_impl


# ---------------------------------------------------------------------------
# Gradient with respect to the targets (forces)
# ---------------------------------------------------------------------------
#
# phi_i depends on the target slab only through target i's own slot, so
# the gradient is one vector per target: the field kernels sum
# 2 G'(r^2) d q beside G q over the very pairs of `execute` (both lanes,
# the same counts and skin routing), the approximation lane's over each
# cluster's Chebyshev grid in factored form. Sources are held fixed: the
# tree is rebuilt or refitted, not differentiated, when they move. Under a
# `PeriodicBox` d is the minimum-image displacement, so forces point
# along it (the reference's JVP of the fold is the identity too).


def potential_and_gradient(arrays: dict, charges: torch.Tensor,
                           params=None, **opts):
    """(phi (N,), g (N, 3)) with g_i = d phi_i / d x_i, input order.

    One modified-charge call and one field launch per lane; `opts` are
    those of `_execute_impl`. The approximation lane takes the difference
    form of r^2 whatever `approx_r2` says, on both backends (the gradient
    needs the displacement; against the matmul form only rounding
    differs)."""
    f = _sweep("field", arrays, charges, params, **opts)
    return f[..., 0], f[..., 1:]


def potential_and_forces(arrays: dict, charges: torch.Tensor,
                         weights: torch.Tensor, params=None, **opts):
    """(phi, F) with F_i = -weights_i * d phi_i / d x_i, input order.

    With targets == sources and weights == charges this is the physical
    force -q_i grad phi(x_i). `opts` are those of
    `potential_and_gradient`."""
    phi, g = potential_and_gradient(arrays, charges, params, **opts)
    return phi, -weights[..., None] * g


# ---------------------------------------------------------------------------
# The differentiable executor: target and charge cotangents
# ---------------------------------------------------------------------------
#
# `differentiable_execute` is `execute` as a `torch.autograd.Function` of
# the target slab and the charges (the reference's `jax.custom_vjp`). Its
# backward, for a cotangent u of phi (input order):
#   - targets: phi_i depends on the slab only through target i's slot, so
#     the cotangent is u_i g_i (g the field sweep of the forward's routed
#     lists) scattered into target i's slot;
#   - charges: phi = A q is linear, so qbar = A^T u, the treecode operator
#     transposed stage by stage. Both lanes are sums of G(r^2(x, y)) with
#     r^2 symmetric in x and y (in every fold: rint and round are odd), so
#     the batch-cluster kernel computes each transposed lane with the roles
#     swapped: the clusters' Chebyshev grids and the leaves' particles as
#     the rows, the batch rows with u as the sources, over the transposed
#     lists. The lanes give q_hat's cotangent and the direct part of qbar;
#     the modified charges' transpose (and for the hierarchical precompute
#     first the upward pass's, root first) takes q_hat's cotangent to the
#     particles.
# Sources and kernel parameters are constants (their cotangent is None),
# as in the reference.


def transposed_lists(idx: torch.Tensor, num_rows: int):
    """The transpose of a (B, S) -1-padded list of row ids below
    `num_rows`: ((num_rows, S_T) int32 batch ids per row, ascending and
    -1-padded; (num_rows,) int32 counts). Pair (b, c) of `idx` is one slot
    of row c (a pair listed twice, twice).

    Tensor ops only: a stable sort of the flattened ids, a bincount and a
    scatter to unique slots (no float atomics). S_T is the largest count,
    at least 1: the one host read (a sync on the card)."""
    s = idx.shape[1]
    dev = idx.device
    key = idx.reshape(-1).long()
    key = torch.where(key >= 0, key, num_rows)           # sentinels last
    order = torch.sort(key, stable=True).indices         # batches ascending
    row = key[order]
    counts = torch.bincount(key, minlength=num_rows + 1)[:num_rows + 1]
    start = torch.cumsum(counts, 0) - counts
    with _rt.explicit_sync("transpose_width"):
        width = max(1, int(counts[:num_rows].max())) if num_rows else 1
    rank = torch.arange(key.numel(), device=dev) - start[row]
    dump = num_rows * width                              # sentinels' slot
    pos = torch.where(row < num_rows, row * width + rank, dump)
    out = torch.full((dump + 1,), -1, dtype=torch.int32, device=dev)
    out[pos] = (order // s).to(torch.int32)
    return (out[:dump].view(num_rows, width),
            counts[:num_rows].to(torch.int32))


def _to_slots(v: torch.Tensor, arrays: dict) -> torch.Tensor:
    """(B, NB, ...) values of `v` (input order, (N, ...)) in their target
    slots, 0 on every padded slot. Real targets own one slot each, so the
    scatter writes unique slots; padded point-budget entries, which share
    the scratch row's first slot, are masked to 0."""
    mask = arrays["tgt_mask"]
    flat = v.new_zeros((mask.numel(),) + v.shape[1:])
    flat[arrays["gather_index"]] = v
    keep = mask.reshape((-1,) + (1,) * (v.dim() - 1))
    return torch.where(keep, flat, torch.zeros_like(flat)).view(
        mask.shape + v.shape[1:])


def _qhat_bar_direct(arrays, qhat_bar, *, degree, backend):
    """The transpose of `compute_qhat_direct`: (N,) in tree order. The
    tiles of the leaves' chunks, each with its chain of nodes over the
    plan's levels (`tile_table`, built on the device)."""
    src = arrays["src_sorted"]
    tiles, chain = tile_table(arrays["mc_chunks"], arrays["parent_of"],
                              len(arrays["bucket_nodes"]), src.shape[0])
    return ops.modified_charges_transpose_ranged(
        src, qhat_bar, tiles, chain, arrays["node_lo"], arrays["node_hi"],
        degree=degree, backend=backend)


def _qhat_bar_hierarchical(arrays, qhat_bar, *, degree, backend):
    """The transpose of `compute_qhat_hierarchical`: (N,) in tree order.

    The downward pass, root first: each child's cotangent takes the
    restriction's transpose of its parent's (final by then). Children are
    unique within a level, so each row is written once (padded pairs name
    the scratch node, whose cotangent is 0). Then the leaves' modified
    charges transposed over the tiles of the leaf chunk table, each with
    a chain of one node (its leaf)."""
    lo, hi = arrays["node_lo"], arrays["node_hi"]
    n1 = degree + 1
    qb = qhat_bar.clone()
    for pairs in reversed(arrays["upward_pairs"]):         # root first
        parents, children = pairs[:, 0], pairs[:, 1]
        rows = _restriction_rows(lo, hi, parents, children, degree, False)
        pb = qb[parents].reshape(-1, n1, n1, n1)
        down = torch.einsum("pxa,pyb,pzc,pabc->pxyz", rows[0], rows[1],
                            rows[2], pb)
        qb[children] = qb[children] + down.reshape(-1, n1 ** 3)
    src = arrays["src_sorted"]
    tiles, chain = tile_table(arrays["mc_leaf_chunks"], arrays["parent_of"],
                              1, src.shape[0])
    return ops.modified_charges_transpose_ranged(
        src, qb, tiles, chain, lo, hi, degree=degree, backend=backend)


_QHAT_BAR = {"direct": _qhat_bar_direct,
             "hierarchical": _qhat_bar_hierarchical}


def transposed_lane_inputs(arrays: dict, u: torch.Tensor, lists, *,
                           degree: int) -> dict:
    """The transposed pass's batch-cluster inputs for the cotangent u
    (input order) over the routed `lists` (approx_idx, direct_idx) the
    forward swept: ``{"approx": (rows, pts, u_slots, counts), "direct":
    (...)}`` with the roles swapped. The rows are the clusters' Chebyshev
    grids (every point real), then the leaves' particles with their
    counts; the sources are the batch rows with u in their slots (0 on
    padded ones) and the batches' target counts; each lane's list is its
    `transposed_lists`. `chip_smoke.py` holds the kernel against its
    plain version on these very tensors."""
    approx_idx, direct_idx = lists
    lo, hi, lg = arrays["node_lo"], arrays["node_hi"], arrays["leaf_gather"]
    src_count = arrays["tgt_mask"].sum(-1, dtype=torch.int32)
    u_slots = _to_slots(u, arrays)
    valid = lg >= 0
    leaf_pts = torch.where(valid[..., None],
                           arrays["src_sorted"][lg.clamp(min=0)],
                           torch.zeros((), dtype=u.dtype, device=u.device))
    return {"approx": (transposed_lists(approx_idx, lo.shape[0])[0],
                       cheby.cluster_grid(lo, hi, degree), u_slots,
                       {"src_count": src_count}),
            "direct": (transposed_lists(direct_idx, lg.shape[0])[0],
                       leaf_pts, u_slots,
                       {"tgt_count": valid.sum(-1, dtype=torch.int32),
                        "src_count": src_count})}


def _charge_cotangent(arrays: dict, u: torch.Tensor, params, lists, *,
                      degree: int, kernel: Kernel, space=_FREE,
                      backend: str = "auto", kahan: bool = False,
                      approx_r2: str = "diff", precompute: str = "direct",
                      **_) -> torch.Tensor:
    """qbar = A^T u (charges' shape): the adjoint sweep of `execute` over
    the routed `lists` it swept.

    One batch-cluster call per lane of `transposed_lane_inputs`, the
    approximation lane's giving q_hat's cotangent, the direct lane's the
    leaves' particles' share; the precompute's transpose on the former;
    the two parts added in tree order and scattered to input order
    through `src_perm` (unique)."""
    lg, tgt = arrays["leaf_gather"], arrays["tgt_batched"]
    n = arrays["src_sorted"].shape[0]
    out = {}
    for lane, (rows, pts, u_slots, counts) in transposed_lane_inputs(
            arrays, u, lists, degree=degree).items():
        if lane == "approx":
            counts = dict(counts, r2_mode=approx_r2)
        with _trace.span(f"eval.{lane}_transpose"):
            out[lane] = ops.batch_cluster_eval(
                rows, pts, tgt, u_slots, params, kernel=kernel, space=space,
                backend=backend, kahan=kahan, **counts)
            _trace.sync(u.device)
    # every particle owns one leaf slot; padded slots (0 by the count
    # contract) go to a dropped slot n
    direct = out["direct"].new_zeros((n + 1,))
    direct[torch.where(lg >= 0, lg, n)] = out["direct"]
    with _trace.span("eval.modified_charges_transpose"):
        q_sorted_bar = direct[:n] + _QHAT_BAR[precompute](
            arrays, out["approx"], degree=degree, backend=backend)
        _trace.sync(u.device)
    qbar = torch.empty_like(q_sorted_bar)
    qbar[arrays["src_perm"]] = q_sorted_bar
    return qbar


class _PhiFromTargets(torch.autograd.Function):
    """phi of `_execute_impl` as a function of (target slab, charges);
    the plan's other arrays, the kernel parameters and the options are
    constants. The forward saves the lists it routed, so the backward
    sweeps the same pairs without routing again."""

    @staticmethod
    def forward(ctx, tgt, charges, arrays, params, opts):
        a = dict(arrays, tgt_batched=tgt)
        lists = routed_lists(a, theta=opts["theta"], space=opts["space"],
                             skin=opts["skin"])
        phi = _sweep("lane", a, charges, params, lists=lists, **opts)
        ctx.save_for_backward(tgt, charges)
        ctx.arrays = {k: v for k, v in arrays.items() if k != "tgt_batched"}
        ctx.params, ctx.opts, ctx.lists = params, opts, lists
        return phi

    @staticmethod
    @once_differentiable
    def backward(ctx, u):
        tgt, charges = ctx.saved_tensors
        a = dict(ctx.arrays, tgt_batched=tgt)
        u = u.contiguous()
        tbar = qbar = None
        if ctx.needs_input_grad[0]:
            with _trace.span("eval.target_cotangent"):
                g = _sweep("field", a, charges, ctx.params, lists=ctx.lists,
                           **ctx.opts)[:, 1:]
                tbar = _to_slots(u[:, None] * g, a)
        if ctx.needs_input_grad[1]:
            with _trace.span("eval.charge_cotangent"):
                qbar = _charge_cotangent(a, u, ctx.params, ctx.lists,
                                         **ctx.opts)
        if _rt.DEBUG_NANS:
            for what, v in (("target", tbar), ("charge", qbar)):
                if v is not None:
                    _rt.check_finite(v, f"differentiable_execute backward "
                                        f"({what} cotangent)")
        return tbar, qbar, None, None, None


def differentiable_execute(arrays: dict, charges: torch.Tensor, params=None,
                           *, degree: int, kernel: Kernel, space=_FREE,
                           backend: str = "auto", kahan: bool = False,
                           precompute: str = "direct",
                           approx_r2: str = "diff", theta: float = 0.7,
                           skin: float = 0.0) -> torch.Tensor:
    """`execute` with a backward with respect to the target coordinates
    and the charges.

    Differentiable in ``arrays["tgt_batched"]`` (forces, target-position
    optimization) and in `charges` (inverse problems, adjoint solves);
    source geometry is treated as fixed, matching the treecode convention
    that the tree is rebuilt, not differentiated, when sources move, and
    the kernel parameters' cotangent is None. The backward computes only
    the cotangents autograd asks for: the target one from one field sweep
    of the forward's routed lists (u_i g_i in target i's slot, 0 in padded
    slots), the charge one from the transposed pass (`_charge_cotangent`).
    Once differentiable. One plan only: stacked (ensemble) arrays raise
    ValueError, as the reference has no stacked differentiable executor."""
    if stacked(arrays):
        raise ValueError("differentiable_execute takes one plan's arrays, "
                         "not an ensemble's stacked ones")
    opts = dict(degree=degree, kernel=kernel, space=space, backend=backend,
                kahan=kahan, precompute=precompute, approx_r2=approx_r2,
                theta=theta, skin=skin)
    return _PhiFromTargets.apply(arrays["tgt_batched"], charges, arrays,
                                 params, opts)


# ---------------------------------------------------------------------------
# Capacity padding: shape-stable replans for moving particles (MD)
# ---------------------------------------------------------------------------
#
# `prepare_plan` pads every ragged structure to its immediate need, so a
# replan over moved particles gives slightly different shapes. PyTorch
# runs eagerly and compiles nothing per shape, but stable shapes keep
# device allocations reusable and are what a captured CUDA graph needs.
# `Capacities` fixes a budget per padded dimension (initial need x
# headroom, grown geometrically when exceeded) and `pad_plan` re-pads any
# plan into it (the reference's conventions, every sentinel adds 0):
#   - node rows: lo = 0, hi = 1 (a non-degenerate box), with one
#     reserved SCRATCH row (id = num_nodes - 1) absorbing sentinel
#     writes;
#   - gather tables (leaf_gather, bucket_gather) and interaction lists:
#     -1;
#   - bucket_nodes / parent_of: the scratch row;
#   - target slab: zero rows, never referenced by gather_index;
#   - the port's chunk table of the modified charges: `mc_chunk_ptr`
#     padded to num_nodes + 1 with its last value (scratch and padded
#     nodes own no chunk, so their q_hat is 0), `mc_chunks` to a chunk
#     budget with empty ranges (scratch, 0, 0);
#   - with point budgets: padded gather_index entries point at the first
#     slot of the SCRATCH BATCH row (the last one, masked and list-free,
#     so its potential is exactly 0), src_sorted gets zero rows and
#     src_perm the slots arange(N, num_sources) (charges arrive padded
#     with zeros); padded particles lie in no node's range, so they own
#     no chunk.


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Fixed padded-dimension budget for shape-stable replans.

    The reference's single-device schema plus the budgets of the port's
    chunk tables: `num_chunks` rows of the modified charges' table and,
    for the hierarchical precompute, `num_leaf_chunks` rows of the
    leaves' one (0 without it). `upward_rows` budgets the upward pass's
    (parent, child) pairs per level; `sparse_rows` /
    `batch_sparse_rows` the occupied cells of a device-built octree's
    levels past its dense split (`repro_torch.devtree`).

    `num_targets` / `num_sources` are the opt-in point budgets of the
    ensemble setting (`repro_torch.serve`): 0, the MD default, leaves the
    particle axes unpadded. When set, `pad_plan` also pads the source
    slab, the source permutation and the targets' `gather_index`, so
    plans over DIFFERENT particle counts become shape-identical and stack
    along a systems axis; such plans reserve one scratch batch row (the
    last) that absorbs the padded `gather_index` entries, and their
    executors take charges padded with zeros to `num_sources`. Point
    budgets enter only through needs dicts with explicit
    ``num_targets`` / ``num_sources`` keys; `for_plan` / `grown_to_fit`
    never enable them."""

    num_batches: int
    batch_width: int
    num_leaves: int
    leaf_width: int
    num_nodes: int                    # includes the +1 scratch row
    approx_width: int
    direct_width: int
    skin_direct_width: int            # gated Verlet-skin direct list
    depth: int                        # tree levels (bucket count)
    bucket_rows: Tuple[int, ...]      # len == depth
    bucket_widths: Tuple[int, ...]    # len == depth, powers of two
    num_chunks: int = 0               # rows of the chunk table
    upward_rows: Tuple[int, ...] = ()  # len == depth - 1 (hierarchical)
    num_leaf_chunks: int = 0          # rows of the leaves' chunk table
    sparse_rows: Tuple[int, ...] = ()  # device octree, past the split
    batch_sparse_rows: Tuple[int, ...] = ()
    num_targets: int = 0              # 0 = unbudgeted (fixed-N replans)
    num_sources: int = 0
    headroom: float = 1.15
    growth: float = 1.5

    @property
    def scratch_node(self) -> int:
        return self.num_nodes - 1

    @property
    def points_budgeted(self) -> bool:
        return self.num_targets > 0

    @property
    def scratch_batch(self) -> int:
        """The batch row absorbing padded gather_index entries (point
        budgets only; its slots are never real targets)."""
        return self.num_batches - 1

    @classmethod
    def for_plan(cls, plan: Plan, headroom: float = 1.15,
                 growth: float = 1.5) -> "Capacities":
        """Initial budget: the plan's own shapes inflated by `headroom`."""
        return cls.for_need(_plan_dims(plan), headroom, growth)

    @classmethod
    def for_need(cls, need: dict, headroom: float = 1.15,
                 growth: float = 1.5, base: int = 8) -> "Capacities":
        """Initial budget from a needs dict (`_plan_dims` keys).

        Explicit ``num_targets`` / ``num_sources`` keys enable the point
        budgets and reserve the scratch batch row. `headroom` / `base`
        trade slack against padded kernel work: the MD default (1.15 / 8)
        buys drift room; ensembles want tight budgets (1.0 / 1), since
        their padded slots are work multiplied by the ensemble width."""

        def h(x):
            return _round_up(int(np.ceil(x * headroom)), base)

        points = bool(need.get("num_targets", 0))
        return cls(
            num_targets=_round_up(need["num_targets"], base) if points else 0,
            num_sources=_round_up(need["num_sources"], base) if points else 0,
            num_batches=h(need["num_batches"]) + (1 if points else 0),
            batch_width=h(need["batch_width"]),
            num_leaves=h(need["num_leaves"]),
            leaf_width=h(need["leaf_width"]),
            num_nodes=h(need["num_nodes"]) + 1,
            approx_width=h(need["approx_width"]),
            direct_width=h(need["direct_width"]),
            skin_direct_width=h(need.get("skin_direct_width", 1)),
            depth=need["depth"],
            bucket_rows=tuple(h(r) for r in need["bucket_rows"]),
            bucket_widths=tuple(_round_pow2(w) for w in need["bucket_widths"]),
            num_chunks=h(need["num_chunks"]),
            upward_rows=tuple(h(r) for r in need.get("upward_rows", ())),
            num_leaf_chunks=(h(need["num_leaf_chunks"])
                             if need.get("num_leaf_chunks") else 0),
            sparse_rows=tuple(h(r) for r in need.get("sparse_rows", ())),
            batch_sparse_rows=tuple(
                h(r) for r in need.get("batch_sparse_rows", ())),
            headroom=headroom, growth=growth,
        )

    def grown_to_fit(self, plan: Plan) -> "Capacities":
        """Smallest capacities >= self that fit `plan`, growing any
        insufficient dimension geometrically (never shrinks)."""
        return self.grown_to_fit_need(_plan_dims(plan))

    def grown_to_fit_need(self, need: dict) -> "Capacities":
        """`grown_to_fit` from a needs dict (`_plan_dims` keys, and the
        point keys when the budget has them)."""

        def g(cap, n, rounder=_round_up):
            if n <= cap:
                return cap
            return rounder(max(n, int(np.ceil(cap * self.growth))))

        def gt(caps, needs, rounder=_round_up):
            caps = tuple(caps) + tuple(
                rounder(int(np.ceil(n * self.headroom)))
                for n in needs[len(caps):])
            return tuple(g(c, n, rounder) for c, n
                         in zip(caps, tuple(needs) + (0,) * len(caps)))

        # point budgets grow only when active; the +1 keeps the scratch
        # batch row (the last one) clear of real target batches
        points = self.points_budgeted
        return dataclasses.replace(
            self,
            num_targets=(g(self.num_targets, need.get("num_targets", 0))
                         if points else 0),
            num_sources=(g(self.num_sources, need.get("num_sources", 0))
                         if points else 0),
            num_batches=g(self.num_batches,
                          need["num_batches"] + (1 if points else 0)),
            batch_width=g(self.batch_width, need["batch_width"]),
            num_leaves=g(self.num_leaves, need["num_leaves"]),
            leaf_width=g(self.leaf_width, need["leaf_width"]),
            num_nodes=g(self.num_nodes, need["num_nodes"] + 1),
            approx_width=g(self.approx_width, need["approx_width"]),
            direct_width=g(self.direct_width, need["direct_width"]),
            skin_direct_width=g(self.skin_direct_width,
                                need.get("skin_direct_width", 1)),
            depth=max(self.depth, need["depth"]),
            bucket_rows=gt(self.bucket_rows, need["bucket_rows"]),
            bucket_widths=gt(self.bucket_widths, need["bucket_widths"],
                             _round_pow2),
            num_chunks=g(self.num_chunks, need["num_chunks"]),
            upward_rows=gt(self.upward_rows, need.get("upward_rows", ())),
            num_leaf_chunks=g(self.num_leaf_chunks,
                              need.get("num_leaf_chunks", 0)),
            sparse_rows=gt(self.sparse_rows, need.get("sparse_rows", ())),
            batch_sparse_rows=gt(self.batch_sparse_rows,
                                 need.get("batch_sparse_rows", ())),
        )

    def fits(self, plan: Plan) -> bool:
        return self.grown_to_fit(plan) == self


@dataclasses.dataclass(frozen=True)
class ShardedCapacities:
    """Fixed budget for a sharded plan's stacked (P, ...) arrays
    (`repro_torch.distributed.bltc.ShardedPlan`, DESIGN.md §7).

    The per-rank dimensions reuse the single-device schema over the
    element-wise max of the ranks' needs (`rank`, a `Capacities`, chunk
    tables included); the cross-rank LET structures get their own:

      slab_width           particle slab width per rank (`per_pad`)
      remote_approx_width  gathered-cluster list width per batch
      remote_direct_width  received-halo-leaf list width per batch
      halo_offsets         the FIXED halo schedule: one round per rank
                           offset over a symmetric contiguous range ±D,
                           so RCB re-cuts keep the rounds; rounds a build
                           does not need run fully masked
      halo_width           leaf-slot budget per halo round

    Two builds padded into equal budgets have equal array shapes and the
    same rounds (`perm_rounds` derives from `halo_offsets` alone), with
    the headroom and geometric growth of `Capacities`."""

    rank: Capacities                  # per-rank budget (num_nodes incl.
                                      # the scratch row, as single-device)
    nranks: int
    slab_width: int
    remote_approx_width: int
    remote_direct_width: int
    halo_offsets: Tuple[int, ...]
    halo_width: int
    headroom: float = 1.15
    growth: float = 1.5

    @property
    def scratch_node(self) -> int:
        return self.rank.scratch_node

    @property
    def halo_rounds(self) -> int:
        return len(self.halo_offsets)

    @staticmethod
    def _offset_range(offsets) -> Tuple[int, ...]:
        """The symmetric round schedule covering `offsets`: every nonzero
        offset in [-D, D], D = max |offset| (at least 1, so even a
        halo-free build keeps a usable budget for later drift)."""
        d = max([abs(int(o)) for o in offsets] + [1])
        return tuple(o for o in range(-d, d + 1) if o != 0)

    @classmethod
    def for_need(cls, need: dict, headroom: float = 1.15,
                 growth: float = 1.5) -> "ShardedCapacities":
        """Initial budget: the build's own needs inflated by `headroom`."""

        def h(x):
            return _round_up(int(np.ceil(x * headroom)))

        return cls(
            rank=Capacities.for_need(need["rank"], headroom, growth),
            nranks=int(need["nranks"]),
            slab_width=h(need["slab_width"]),
            remote_approx_width=h(need["remote_approx_width"]),
            remote_direct_width=h(need["remote_direct_width"]),
            halo_offsets=cls._offset_range(need["halo_offsets"]),
            halo_width=h(need["halo_width"]),
            headroom=headroom, growth=growth,
        )

    def grown_to_fit(self, need: dict) -> "ShardedCapacities":
        """Smallest capacities >= self fitting `need`: an insufficient
        width grows geometrically, and a rank offset outside the round
        schedule widens the symmetric range (both counted growths in
        `Simulation.stats`)."""
        if int(need["nranks"]) != self.nranks:
            raise ValueError(
                f"sharded capacities are bound to nranks={self.nranks}; "
                f"got a build over nranks={need['nranks']}")

        def g(cap, n):
            if n <= cap:
                return cap
            return _round_up(max(n, int(np.ceil(cap * self.growth))))

        offsets = self.halo_offsets
        if not set(need["halo_offsets"]) <= set(offsets):
            offsets = self._offset_range(
                tuple(offsets) + tuple(need["halo_offsets"]))
        return dataclasses.replace(
            self,
            rank=self.rank.grown_to_fit_need(need["rank"]),
            slab_width=g(self.slab_width, need["slab_width"]),
            remote_approx_width=g(self.remote_approx_width,
                                  need["remote_approx_width"]),
            remote_direct_width=g(self.remote_direct_width,
                                  need["remote_direct_width"]),
            halo_offsets=offsets,
            halo_width=g(self.halo_width, need["halo_width"]),
        )

    def fits(self, need: dict) -> bool:
        return self.grown_to_fit(need) == self


def _plan_dims(plan: Plan) -> dict:
    """The plan's padded dimensions (the needs a `Capacities` budgets)."""
    a = plan.arrays
    bg = a["bucket_gather"]
    dev = plan.dev or {}
    return dict(
        num_batches=a["tgt_batched"].shape[0],
        batch_width=a["tgt_batched"].shape[1],
        num_leaves=a["leaf_gather"].shape[0],
        leaf_width=a["leaf_gather"].shape[1],
        num_nodes=a["node_lo"].shape[0],
        approx_width=a["approx_idx"].shape[1],
        direct_width=a["direct_idx"].shape[1],
        skin_direct_width=a["skin_direct"].shape[1],
        depth=len(bg),
        bucket_rows=tuple(g.shape[0] for g in bg),
        bucket_widths=tuple(g.shape[1] for g in bg),
        num_chunks=a["mc_chunks"].shape[0],
        upward_rows=tuple(p.shape[0] for p in a.get("upward_pairs", ())),
        num_leaf_chunks=(a["mc_leaf_chunks"].shape[0]
                         if "mc_leaf_chunks" in a else 0),
        sparse_rows=tuple(dev.get("sparse_occ", ())),
        batch_sparse_rows=tuple(dev.get("batch_sparse_occ", ())),
    )


def _pad_to(t: torch.Tensor, shape: Tuple[int, ...], value) -> torch.Tensor:
    """`t` padded at the end of its leading dims to `shape` with `value`
    (trailing dims kept), on t's device."""
    if any(s < d for s, d in zip(shape, t.shape)):
        raise ValueError(f"cannot pad {tuple(t.shape)} into {shape}")
    out = t.new_full(tuple(shape) + tuple(t.shape[len(shape):]), value)
    out[tuple(slice(0, d) for d in t.shape[:len(shape)])] = t
    return out


def pad_plan(plan: Plan, caps: Capacities) -> Plan:
    """Re-pad a plan's device arrays into the fixed `caps` budget.

    The returned plan computes the same potentials and forces (every
    padded slot is masked, or owned by the scratch node) but its array
    shapes depend only on `caps`. The padding runs on the plan's device;
    the host trees are kept for diagnostics. With point budgets its
    executors take charges padded with zeros to `caps.num_sources` and
    give `caps.num_targets` potentials, exactly 0 past the real ones."""
    with _trace.span("plan.pad"):
        return _pad_plan_impl(plan, caps)


def _pad_plan_impl(plan: Plan, caps: Capacities) -> Plan:
    t_pad = time.perf_counter()
    if not caps.fits(plan):
        raise ValueError(
            "capacities do not fit this plan; call caps.grown_to_fit(plan) "
            "first (the growth is a deliberate, counted event)")
    if caps.points_budgeted and (plan.num_targets > caps.num_targets
                                 or plan.num_sources > caps.num_sources):
        # `fits` cannot see this: point budgets grow only through needs
        # dicts with explicit num_targets / num_sources keys
        raise ValueError(
            f"plan ({plan.num_targets} targets / {plan.num_sources} "
            f"sources) exceeds the point budget ({caps.num_targets} / "
            f"{caps.num_sources}); grow via grown_to_fit_need with "
            f"explicit num_targets/num_sources keys")
    a = plan.arrays
    scratch = caps.scratch_node
    nb_old = a["tgt_batched"].shape[1]
    gi = a["gather_index"]
    if nb_old != caps.batch_width:
        gi = (gi // nb_old) * caps.batch_width + gi % nb_old
    rows = (caps.num_batches,)
    out = dict(
        src_sorted=a["src_sorted"],
        src_perm=a["src_perm"],
        tgt_batched=_pad_to(a["tgt_batched"], rows + (caps.batch_width,), 0),
        gather_index=gi,
        leaf_gather=_pad_to(a["leaf_gather"],
                            (caps.num_leaves, caps.leaf_width), -1),
        node_lo=_pad_to(a["node_lo"], (caps.num_nodes,), 0),
        node_hi=_pad_to(a["node_hi"], (caps.num_nodes,), 1),
        approx_idx=_pad_to(a["approx_idx"], rows + (caps.approx_width,), -1),
        direct_idx=_pad_to(a["direct_idx"], rows + (caps.direct_width,), -1),
        approx_skin=_pad_to(a["approx_skin"], rows + (caps.approx_width,),
                            0),
        skin_direct=_pad_to(a["skin_direct"],
                            rows + (caps.skin_direct_width,), -1),
        skin_direct_node=_pad_to(a["skin_direct_node"],
                                 rows + (caps.skin_direct_width,), -1),
        tgt_mask=_pad_to(a["tgt_mask"], rows + (caps.batch_width,), False),
        parent_of=_pad_to(a["parent_of"], (caps.num_nodes,), scratch),
    )
    if caps.points_budgeted:
        if a["tgt_batched"].shape[0] >= caps.num_batches:
            raise ValueError("point-budgeted capacities must keep the "
                             "scratch batch row free of real batches")
        nt, ns = plan.num_targets, plan.num_sources
        out["gather_index"] = torch.cat([gi, gi.new_full(
            (caps.num_targets - nt,),
            caps.scratch_batch * caps.batch_width)])
        out["src_sorted"] = _pad_to(a["src_sorted"], (caps.num_sources,), 0)
        out["src_perm"] = torch.cat([a["src_perm"], torch.arange(
            ns, caps.num_sources, dtype=a["src_perm"].dtype,
            device=a["src_perm"].device)])
    bgs, bns = [], []
    for lvl in range(caps.depth):
        shape = (caps.bucket_rows[lvl], caps.bucket_widths[lvl])
        if lvl < len(a["bucket_gather"]):
            bgs.append(_pad_to(a["bucket_gather"][lvl], shape, -1))
            bns.append(_pad_to(a["bucket_nodes"][lvl], shape[:1], scratch))
        else:
            like = a["bucket_gather"][0]
            bgs.append(like.new_full(shape, -1))
            bns.append(a["bucket_nodes"][0].new_full(shape[:1], scratch))
    out["bucket_gather"] = tuple(bgs)
    out["bucket_nodes"] = tuple(bns)
    out.update(zip(CHUNK_KEYS, _pad_chunks(
        a["mc_chunks"], a["mc_chunk_ptr"], caps.num_chunks, caps)))
    if "upward_pairs" in a:
        ups = []
        for slot, rows in enumerate(caps.upward_rows):
            if slot < len(a["upward_pairs"]):
                ups.append(_pad_to(a["upward_pairs"][slot], (rows,),
                                   scratch))
            else:
                ups.append(a["upward_pairs"][0].new_full((rows, 2),
                                                         scratch))
        out["upward_pairs"] = tuple(ups)
        kids = []
        for slot, rows in enumerate(caps.upward_rows):
            if slot < len(a["upward_children"]):
                kids.append(_pad_to(a["upward_children"][slot], (rows,), -1))
            else:
                kids.append(a["upward_children"][0].new_full(
                    (rows, MAX_CHILDREN), -1))
        out["upward_children"] = tuple(kids)
        out.update(zip(LEAF_CHUNK_KEYS, _pad_chunks(
            a["mc_leaf_chunks"], a["mc_leaf_chunk_ptr"],
            caps.num_leaf_chunks, caps)))
    build_ms = dict(plan.build_ms)
    build_ms["pad"] = build_ms.get("pad", 0.0) \
        + (time.perf_counter() - t_pad) * 1e3
    return dataclasses.replace(plan, arrays=out, capacities=caps,
                               scratch_node=scratch, build_ms=build_ms)


def _pad_chunks(chunks, ptr, rows: int, caps: Capacities):
    """A chunk table padded into `rows` chunk rows and the node budget:
    the pointer repeats its last value (padded nodes own no chunk) and
    the padded rows are empty ranges (scratch, 0, 0)."""
    out_ptr = _pad_to(ptr, (caps.num_nodes + 1,), 0)
    out_ptr[ptr.shape[0]:] = ptr[-1]
    out = _pad_to(chunks, (rows,), 0)
    out[chunks.shape[0]:, 0] = caps.scratch_node
    return out, out_ptr


def plan_signature(plan) -> Tuple:
    """Hashable shape/dtype signature of a plan's device arrays (the chunk
    table's budget included): equal signatures mean equal shapes, the
    MD engine's test for a capacity growth. Any object with `arrays`
    (an ensemble's stacked ones too) has one."""
    return _arrays_signature(plan.arrays)


def _arrays_signature(arrays: dict) -> Tuple:
    def leaf_sig(v):
        return (tuple(v.shape), str(v.dtype))

    return tuple(sorted(
        (k, tuple(leaf_sig(x) for x in v) if isinstance(v, tuple)
         else leaf_sig(v))
        for k, v in arrays.items()))


# ---------------------------------------------------------------------------
# Ensemble executors: one launch per kernel over a leading systems axis
# ---------------------------------------------------------------------------
#
# Plans padded into one point-budgeted `Capacities` have identical shapes,
# so W of them stack along a leading axis (every array (W, ...)), and the
# executors above run on the stack as they are (`_execute_impl`,
# `potential_and_forces`: the reference's `_ensemble_execute_impl` and
# `_ensemble_pf_impl` are their vmaps): the gathers take each
# system's rows (`ops.take`), and each kernel makes ONE launch for all W
# systems (the systems axis of `kernels.ops`), with per-system charges
# (W, num_sources), weights and kernel parameter values (every leaf with
# a leading W). This is the counterpart of the reference's vmapped
# executors, and what `repro_torch.serve` builds on. Nothing is traced, so
# a "compile" is what `obs.events.log_compiles` counts: the first call of
# an executor on a stacked signature, plus kernel libraries built during
# a call (`ensemble_compile_count`).

#: Owner of the ensemble executors' events in `repro_torch.obs.events`.
ENSEMBLE_OWNER = _events.owner_token("ensemble")
_ENSEMBLE_SEEN = {"ensemble_execute": set(),
                  "ensemble_potential_and_forces": set()}


def _logged(label: str, fn, arrays: dict, charges: torch.Tensor, *args,
            **opts):
    key = (_arrays_signature(arrays), tuple(charges.shape),
           str(charges.dtype), tuple(sorted(
               (k, repr(v)) for k, v in opts.items())))
    out, _ = _events.log_compiles(label, fn, arrays, charges, *args,
                                  key=key, seen=_ENSEMBLE_SEEN[label],
                                  site="core.eval", owner=ENSEMBLE_OWNER,
                                  **opts)
    return out


def ensemble_execute(arrays: dict, charges: torch.Tensor, params=None,
                     **opts) -> torch.Tensor:
    """Stacked potentials (W, num_targets) for W systems, padded target
    slots exactly 0: one modified-charge call and one batch-cluster
    launch per lane. `opts` are `_execute_impl`'s."""
    return _logged("ensemble_execute", _execute_impl, arrays, charges,
                   params, **opts)


def ensemble_potential_and_forces(arrays: dict, charges: torch.Tensor,
                                  weights: torch.Tensor, params=None,
                                  **opts):
    """Stacked (phi (W, num_targets), F (W, num_targets, 3)) for W
    systems: one modified-charge call and one field launch per lane.
    Padded slots carry zero weights, so their forces are exactly 0."""
    return _logged("ensemble_potential_and_forces", potential_and_forces,
                   arrays, charges, weights, params, **opts)


def ensemble_compile_count() -> int:
    """Events of the ensemble executors so far (first calls on a stacked
    signature and kernel builds during their calls): serving's compile
    and retrace counters difference it."""
    return _events.log.count(owner=ENSEMBLE_OWNER)

"""Device evaluation pipeline: plan (host) -> execute (device).

PyTorch port of the single-device path of `repro/core/eval.py`. The host
packs the tree, batches and interaction lists into static padded arrays
once (`prepare_plan`); `execute` then computes

    modified charges (one launch per tree level)  ->  cluster Chebyshev
    grids  ->  approximation lane over the approx lists  ->  direct lane
    over the leaf lists  ->  un-permutation back to input order.

The packing is NumPy and identical to the reference's, so the same
points give the same plan arrays; `arrays_from_numpy` moves them onto
the plan's device. It also takes a reference plan's arrays (pulled to
NumPy), which is how the tests run both packages on one plan.

Capacity padding (`Capacities`, `pad_plan`, `plan_signature`) and the
hierarchical precompute come with later slices (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core import cheby
from repro_torch.core.interaction import build_interaction_lists
from repro_torch.core.potentials import Kernel
from repro_torch.core.space import FREE as _FREE
from repro_torch.core.tree import Batches, Tree, build_batches, build_tree
from repro_torch.kernels import ops
from repro_torch.obs import trace as _trace


def _round_up(x: int, base: int = 8) -> int:
    return max(base, -(-x // base) * base)


def _round_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(x, 1)))))


# Plan arrays the executor indexes with (torch gathers take int64); the
# interaction lists stay int32, the CUDA kernel's index type.
_INDEX_KEYS = ("src_perm", "gather_index", "leaf_gather", "bucket_gather",
               "bucket_nodes", "parent_of")


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
    # Host build-phase wall times in ms (tree_build / interaction_lists /
    # pack), surfaced via plan.stats().
    build_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.arrays["tgt_batched"].device


def arrays_from_numpy(arrays: dict, *, device, dtype) -> dict:
    """The port's plan arrays from NumPy plan arrays.

    `arrays` is a packed plan dict of NumPy arrays (tuples of per-level
    buckets included), from this module's packing or from a reference
    plan's arrays. Floating arrays become `dtype`, index tables int64,
    interaction lists int32, masks bool/uint8, all on `device`."""
    device = torch.device(device)

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

    # Per-level cluster buckets for the modified-charge kernel, padded
    # particle counts rounded up to powers of two.
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


def _gathered(src_sorted, q_sorted, gather, fill=None):
    """(rows, pad, 3) points and (rows, pad) charges from a -1-padded
    gather table.

    `fill` (rows, 3) replaces padded coordinates: the modified-charge
    kernel passes the cluster center so padded slots stay INSIDE the box
    (a padded point outside it makes the alternating barycentric
    denominator cancel to exactly 0 in f32 at degree 10, and 0/0 = NaN).
    Charges on padding are always 0."""
    valid = gather >= 0
    safe = gather.clamp(min=0)
    pts = src_sorted[safe]
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    fill_b = zero if fill is None else fill[:, None, :]
    pts = torch.where(valid[..., None], pts, fill_b)
    q = torch.where(valid, q_sorted[safe], zero)
    return pts, q


@dataclasses.dataclass
class KernelInputs:
    """What `_execute_impl` feeds the kernels for one charge vector, apart
    from q_hat (which the modified-charge kernel computes from `levels`).
    `chip_smoke.py` holds the kernels against their plain versions on
    these very tensors."""

    q_sorted: torch.Tensor    # (N,) charges in tree order
    # per tree level: node ids, points (C, m, 3) with the cluster center
    # on padded slots, charges (C, m) with 0 there, lo and hi (C, 3)
    levels: list
    grids: torch.Tensor       # (num_nodes, (n+1)^3, 3) Chebyshev grids
    leaf_pts: torch.Tensor    # (num_leaves, nl_pad, 3)
    leaf_q: torch.Tensor      # (num_leaves, nl_pad)


def kernel_inputs(arrays: dict, charges: torch.Tensor, *,
                  degree: int) -> KernelInputs:
    """Gather the kernels' inputs from the plan arrays and `charges`."""
    q_sorted = charges[arrays["src_perm"]]
    lo, hi = arrays["node_lo"], arrays["node_hi"]
    levels = []
    for gidx, nodes in zip(arrays["bucket_gather"], arrays["bucket_nodes"]):
        lo_n, hi_n = lo[nodes], hi[nodes]
        pts, qb = _gathered(arrays["src_sorted"], q_sorted, gidx,
                            fill=0.5 * (lo_n + hi_n))
        levels.append((nodes, pts, qb, lo_n, hi_n))
    leaf_pts, leaf_q = _gathered(arrays["src_sorted"], q_sorted,
                                 arrays["leaf_gather"])
    return KernelInputs(q_sorted=q_sorted, levels=levels,
                        grids=cheby.cluster_grid(lo, hi, degree),
                        leaf_pts=leaf_pts, leaf_q=leaf_q)


def compute_qhat_direct(levels, num_nodes: int, *, degree, backend):
    """Paper-faithful q_hat: every cluster from its own particles (Eq. 12),
    one modified-charge call per tree level of `KernelInputs.levels`."""
    n1 = degree + 1
    q = levels[0][2]
    qhat = torch.zeros((num_nodes, n1 ** 3), dtype=q.dtype, device=q.device)
    for nodes, pts, qb, lo_n, hi_n in levels:
        # in-place index write where the reference used .at[nodes].set
        qhat[nodes] = ops.modified_charges(
            pts, qb, lo_n, hi_n, degree=degree, backend=backend)
    return qhat


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
    direct_idx = torch.cat([arrays["direct_idx"], skin_direct], dim=1)
    return approx_idx, direct_idx


def _execute_impl(
    arrays: dict,
    charges: torch.Tensor,
    params=None,
    *,
    degree: int,
    kernel: Kernel,
    space=_FREE,
    backend: str = "auto",
    kahan: bool = False,
    approx_r2: str = "diff",
    theta: float = 0.7,
    skin: float = 0.0,
) -> torch.Tensor:
    """Potentials at the plan's targets, in the caller's input order.

    `charges` lives on the plan's device. `params` carries kernel
    parameter values (tensors on the device, or None for the kernel's
    defaults). With ``skin > 0`` the Verlet-skin dual lists are routed by
    the runtime MAC gate before the kernels run."""
    inp = kernel_inputs(arrays, charges, degree=degree)
    with _trace.span("eval.modified_charges"):
        qhat = compute_qhat_direct(inp.levels, arrays["node_lo"].shape[0],
                                   degree=degree, backend=backend)
        _trace.sync(charges.device)

    tgt = arrays["tgt_batched"]
    if skin > 0.0:
        approx_idx, direct_idx = _skin_routed_lists(arrays, theta, space)
    else:
        approx_idx, direct_idx = arrays["approx_idx"], arrays["direct_idx"]
    with _trace.span("eval.approx_lane"):
        phi_a = ops.batch_cluster_eval(
            approx_idx, tgt, inp.grids, qhat, params,
            kernel=kernel, space=space, backend=backend, kahan=kahan,
            r2_mode=approx_r2)
        _trace.sync(charges.device)

    with _trace.span("eval.direct_lane"):
        phi_d = ops.batch_cluster_eval(
            direct_idx, tgt, inp.leaf_pts, inp.leaf_q, params,
            kernel=kernel, space=space, backend=backend, kahan=kahan)
        _trace.sync(charges.device)

    phi = (phi_a + phi_d).reshape(-1)
    return phi[arrays["gather_index"]]


#: The executor. PyTorch runs eagerly, so there is no jitted twin: the
#: reference's `execute = jax.jit(_execute_impl, ...)` is the function.
execute = _execute_impl

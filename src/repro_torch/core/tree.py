"""Host-side construction of the source-cluster tree and target batches.

Implements Sec. 2.4 "Source Clusters and Target Batches":
  - root = minimal bounding box of all particles;
  - recursive midpoint bisection, terminating at <= leaf_size particles;
  - after division each child box is SHRUNK to the minimal bounding box of
    its particles;
  - to avoid bad aspect ratios, a node is split into 8, 4, or 2 children:
    only dimensions whose (shrunk) extent is within a factor sqrt(2) of the
    longest extent are bisected.

Tree construction is a *setup phase* (exactly as in the paper, where it runs
on the CPU while the kernels run on the GPU), so it is plain NumPy. The
output is a flat structure-of-arrays with particles permuted into tree order
so every cluster owns a contiguous index range — this is what makes the
static padded device pipeline possible.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.trace import traced as _traced

_SPLIT_RATIO = 1.0 / np.sqrt(2.0)


@dataclasses.dataclass
class Tree:
    """Flat source tree. All node arrays are indexed by node id (root = 0)."""

    lo: np.ndarray        # (M, 3) shrunk box lower corner
    hi: np.ndarray        # (M, 3) shrunk box upper corner
    center: np.ndarray    # (M, 3) box center
    radius: np.ndarray    # (M,)   half-diagonal (paper's cluster radius)
    start: np.ndarray     # (M,)   first particle (in permuted order)
    count: np.ndarray     # (M,)   number of particles
    level: np.ndarray     # (M,)
    parent: np.ndarray    # (M,)   -1 for root
    children: np.ndarray  # (M, 8) child node ids, -1 padded
    is_leaf: np.ndarray   # (M,) bool
    perm: np.ndarray      # (N,) input-index -> tree-order permutation
    leaf_ids: np.ndarray  # (num_leaves,) node ids of leaves, by start order
    leaf_index: np.ndarray  # (M,) node id -> leaf slot or -1

    @property
    def num_nodes(self) -> int:
        return self.lo.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.leaf_ids.shape[0]

    @property
    def max_leaf_count(self) -> int:
        return int(self.count[self.leaf_ids].max())

    def levels(self):
        """Node ids grouped by level, root first."""
        out = []
        for lvl in range(int(self.level.max()) + 1):
            out.append(np.nonzero(self.level == lvl)[0])
        return out

    def leaves_in_range(self, start: int, count: int) -> np.ndarray:
        """Leaf slots whose particle ranges lie within [start, start+count).

        Used to decompose an internal cluster marked for direct interaction
        (the (n+1)^3 >= N_C branch of the MAC) into its constituent leaves.
        """
        starts = self.start[self.leaf_ids]
        i0 = np.searchsorted(starts, start, side="left")
        i1 = np.searchsorted(starts, start + count, side="left")
        return np.arange(i0, i1)


@_traced("tree.build_tree")
def build_tree(points: np.ndarray, leaf_size: int) -> Tree:
    """Build the source tree (or, with leaf_size=N_B, the target batches).

    Space convention: periodic plans build their trees on WRAPPED
    coordinates — the plan builders (`eval.prepare_plan`,
    `ShardedPlan.build`) wrap before calling in, so midpoint bisection
    splits boundary-straddling clusters by construction and every box
    stays inside the cell. Image folding is the kernels' job
    (minimum-image displacements), never the tree's.
    """
    points = np.asarray(points)
    n = points.shape[0]
    if n == 0:
        raise ValueError("cannot build a tree over zero particles")
    perm = np.arange(n)

    lo_l, hi_l, start_l, count_l, level_l, parent_l = [], [], [], [], [], []
    children_l, leaf_l = [], []

    # Stack of (start, count, level, parent, child_slot). Nodes are appended
    # in DFS order; particle ranges of children tile the parent's range.
    stack = [(0, n, 0, -1, -1)]
    while stack:
        start, count, level, parent, slot = stack.pop()
        idx = perm[start:start + count]
        pts = points[idx]
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        node = len(lo_l)
        lo_l.append(lo)
        hi_l.append(hi)
        start_l.append(start)
        count_l.append(count)
        level_l.append(level)
        parent_l.append(parent)
        children_l.append([-1] * 8)
        if parent >= 0:
            children_l[parent][slot] = node

        ext = hi - lo
        max_ext = ext.max()
        # Leaf if small enough, or degenerate (all particles coincident).
        if count <= leaf_size or max_ext == 0.0:
            leaf_l.append(True)
            continue
        leaf_l.append(False)

        # Split only dimensions comparable to the longest one (8/4/2-way).
        split_dims = np.nonzero(ext >= _SPLIT_RATIO * max_ext)[0]
        mid = 0.5 * (lo + hi)
        code = np.zeros(count, dtype=np.int64)
        for b, dim in enumerate(split_dims):
            code |= (pts[:, dim] > mid[dim]).astype(np.int64) << b
        order = np.argsort(code, kind="stable")
        perm[start:start + count] = idx[order]
        code = code[order]
        # Contiguous child ranges; skip empty octants.
        uniq, first = np.unique(code, return_index=True)
        bounds = np.append(first, count)
        childs = []
        for u, b0, b1 in zip(uniq, bounds[:-1], bounds[1:]):
            childs.append((start + int(b0), int(b1 - b0)))
        if len(childs) == 1:
            # All particles on one side of every midpoint: the shrunk box
            # will strictly shrink next iteration, but guard against stalls.
            leaf_l[-1] = True
            children_l[node] = [-1] * 8
            continue
        for cslot, (cs, cc) in enumerate(childs):
            stack.append((cs, cc, level + 1, node, cslot))

    lo_a = np.asarray(lo_l)
    hi_a = np.asarray(hi_l)
    center = 0.5 * (lo_a + hi_a)
    radius = 0.5 * np.linalg.norm(hi_a - lo_a, axis=1)
    is_leaf = np.asarray(leaf_l)
    start_a = np.asarray(start_l)
    leaf_nodes = np.nonzero(is_leaf)[0]
    leaf_ids = leaf_nodes[np.argsort(start_a[leaf_nodes], kind="stable")]
    leaf_index = np.full(len(lo_l), -1, dtype=np.int64)
    leaf_index[leaf_ids] = np.arange(len(leaf_ids))

    return Tree(
        lo=lo_a, hi=hi_a, center=center, radius=radius,
        start=start_a, count=np.asarray(count_l),
        level=np.asarray(level_l), parent=np.asarray(parent_l),
        children=np.asarray(children_l), is_leaf=is_leaf,
        perm=perm, leaf_ids=leaf_ids, leaf_index=leaf_index,
    )


@_traced("tree.refit_tree")
def refit_tree(tree: Tree, points: np.ndarray) -> Tree:
    """Recompute box geometry for moved particles under a FIXED topology.

    Keeps the permutation, particle ranges, parent/child structure and
    leaf set of `tree`; only lo/hi/center/radius are recomputed as the
    minimal bounding box of each node's (moved) particles — exactly what
    `build_tree` would produce for these splits. This is the host oracle
    for a device-side refit: every particle
    stays inside its refitted cluster box, so barycentric interpolation
    remains well-posed; only MAC separation can degrade, which the
    drift-based trigger (`InteractionLists.mac_slack`) guards.
    """
    pts = np.asarray(points)[tree.perm]
    lo = np.empty_like(tree.lo)
    hi = np.empty_like(tree.hi)
    for node in range(tree.num_nodes):
        s, c = int(tree.start[node]), int(tree.count[node])
        seg = pts[s:s + c]
        lo[node] = seg.min(axis=0)
        hi[node] = seg.max(axis=0)
    return dataclasses.replace(
        tree, lo=lo, hi=hi, center=0.5 * (lo + hi),
        radius=0.5 * np.linalg.norm(hi - lo, axis=1))


@dataclasses.dataclass
class Batches:
    """Localized target batches (Sec. 2.4). Targets permuted batch-contiguous."""

    center: np.ndarray  # (B, 3)
    radius: np.ndarray  # (B,)
    start: np.ndarray   # (B,)
    count: np.ndarray   # (B,)
    perm: np.ndarray    # (N,)
    # Per-dimension box half-extents (B, 3): exact per-coordinate target
    # spread, used by the periodic fold-free MAC (radius, the
    # half-diagonal, would be sqrt(3)x too conservative per dimension).
    half_extent: np.ndarray = None

    @property
    def num_batches(self) -> int:
        return self.center.shape[0]

    @property
    def max_count(self) -> int:
        return int(self.count.max())


def build_batches(points: np.ndarray, batch_size: int) -> Batches:
    """Partition targets into batches using the same routine as the tree
    (same wrapped-coordinate convention)."""
    t = build_tree(points, batch_size)
    leaves = t.leaf_ids
    return Batches(
        center=t.center[leaves], radius=t.radius[leaves],
        start=t.start[leaves], count=t.count[leaves], perm=t.perm,
        half_extent=0.5 * (t.hi[leaves] - t.lo[leaves]),
    )

"""Recursive coordinate bisection (port of `repro/distributed/rcb.py`;
Sec. 3.1, the paper uses Zoltan's RCB). NumPy only, like the reference:
the partition runs on the host, in the sharded plan's setup phase.

Splits particles into P contiguous, count-balanced slabs by recursively
bisecting along the longest extent at the index proportional to the rank
counts on each side. Arbitrary N is supported: the proportional split
makes every rank own floor(N/P) or ceil(N/P) particles (the balance
property Fig. 2 illustrates, without the paper's N % P == 0 restriction).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RCB:
    perm: np.ndarray      # (N,) input index -> rank-major order
    rank_of: np.ndarray   # (N,) rank of each input particle
    starts: np.ndarray    # (P+1,) slab boundaries in permuted order
    lo: np.ndarray        # (P, 3) slab bounding boxes (of owned particles)
    hi: np.ndarray        # (P, 3)

    @property
    def nranks(self) -> int:
        return len(self.starts) - 1

    def counts(self) -> np.ndarray:
        return np.diff(self.starts)

    def max_count(self) -> int:
        """Widest slab — the raw need behind the sharded plan's
        `slab_width` budget (`ShardedCapacities`, DESIGN.md §7). RCB is
        count-balanced (|count_r − N/P| <= 1), so across MD rebuilds at
        fixed N this need moves by at most one, which the budget's
        headroom absorbs: re-cuts stay shape-stable."""
        return int(self.counts().max())


def rcb_partition(points: np.ndarray, nranks: int) -> RCB:
    """Partition into P contiguous slabs.

    Space convention: periodic callers (`ShardedPlan.build`) pass WRAPPED
    coordinates, so slabs tile the primary cell — a particle's rank
    follows its canonical image, and cross-boundary interactions are the
    halo exchange's job, driven by the minimum-image remote MAC."""
    points = np.asarray(points)
    n = points.shape[0]
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1, got {nranks}")
    if n < nranks:
        raise ValueError(f"cannot split N={n} particles over P={nranks} "
                         "ranks (every rank needs at least one particle)")
    perm = np.arange(n)
    bounds = [None] * nranks
    counts = np.zeros(nranks, np.int64)

    def recurse(start, count, r0, r1):
        if r1 - r0 == 1:
            idx = perm[start:start + count]
            pts = points[idx]
            bounds[r0] = (pts.min(0), pts.max(0))
            counts[r0] = count
            return
        idx = perm[start:start + count]
        pts = points[idx]
        dim = int(np.argmax(pts.max(0) - pts.min(0)))
        order = np.argsort(pts[:, dim], kind="stable")
        perm[start:start + count] = idx[order]
        rmid = (r0 + r1) // 2
        # Round the cut to the nearest proportional index so leftover
        # particles spread one-per-rank (|count_r - N/P| <= 1 overall).
        left = int(round(count * (rmid - r0) / (r1 - r0)))
        left = min(max(left, rmid - r0), count - (r1 - rmid))
        recurse(start, left, r0, rmid)
        recurse(start + left, count - left, rmid, r1)

    recurse(0, n, 0, nranks)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank_of = np.empty(n, np.int64)
    for r in range(nranks):
        rank_of[perm[starts[r]:starts[r + 1]]] = r
    lo = np.stack([b[0] for b in bounds])
    hi = np.stack([b[1] for b in bounds])
    return RCB(perm=perm, rank_of=rank_of, starts=starts, lo=lo, hi=hi)

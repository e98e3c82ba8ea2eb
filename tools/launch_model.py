#!/usr/bin/env python3
"""Launch-order model of the batch-cluster kernel at the Fig. 4 plan.

    PYTHONPATH=src python tools/launch_model.py [--n 1000000]

Builds the paper's Fig. 4 plan (theta 0.7, degree 8, N_L = N_B = 2000,
N points uniform in [-1,1]^3, seed 2020 as in `chip_smoke.py`) on the
CPU and, for each lane, prints the pairs the kernel's launch geometry
sweeps against the pairs the data needs (`batch_cluster.swept_pairs`).
It then models the launch as list scheduling: a block's work is the
pairs its tile sweeps plus a fixed per-block cost; blocks start in
launch order on the first of `--slots` free resident-block slots (1056
= 132 SMs x 8 blocks of the f32 kernel). It prints the makespan over
the ideal (total work / slots) for the kernel's tile-major order and for
rows sorted by their tile's work, heaviest first, with each row's tiles
together. The model counts pairs only; it does not know that a block
runs faster when it shares its SM with fewer others.
"""
import argparse
import heapq
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.bltc import fig4  # noqa: E402
from repro_torch.core import eval as ev  # noqa: E402
from repro_torch.core.api import TreecodeSolver  # noqa: E402
from repro_torch.kernels import batch_cluster as bcm  # noqa: E402

BLOCK_COST = 1e3   # pairs-equivalent a block costs besides its pairs


def makespan_ratio(works, slots: int) -> float:
    """List scheduling of `works` in order on `slots` identical slots."""
    free = [0.0] * slots
    end = 0.0
    for w in works:
        t = heapq.heappop(free) + w + BLOCK_COST
        end = max(end, t)
        heapq.heappush(free, t)
    return end / ((sum(works) + BLOCK_COST * len(works)) / slots)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--slots", type=int, default=1056)
    args = ap.parse_args()
    rng = np.random.default_rng(2020)
    x = rng.uniform(-1, 1, (args.n, 3)).astype(np.float32)
    q = torch.as_tensor(rng.uniform(-1, 1, args.n).astype(np.float32))
    cfg = fig4(theta=0.7, degree=8)
    plan = TreecodeSolver(cfg, device="cpu").plan(x)
    a = plan.arrays
    inp = ev.kernel_inputs(a, q, degree=cfg.degree)
    b, nb = a["tgt_batched"].shape[:2]
    tile, unroll = bcm._TARGETS_PER_BLOCK, bcm._SOURCE_UNROLL
    nt = inp.tgt_count.long()
    tiles = (-(-nt // tile)).tolist()
    grid = -(-nb // tile)
    n1c = torch.full((a["node_lo"].shape[0],), (cfg.degree + 1) ** 3,
                     dtype=torch.int32)
    lanes = {"approx": (a["approx_idx"], n1c, inp.grids.shape[1], None),
             "direct": (a["direct_idx"], inp.leaf_count,
                        inp.leaf_pts.shape[1], inp.leaf_count)}
    for lane, (idx, counts, m, src_count) in lanes.items():
        valid = idx >= 0
        n = counts.long()[idx.clamp(min=0).long()]
        needed = float((nt[:, None] * n * valid).sum())
        geo = bcm.swept_pairs(idx, nb, m, tgt_count=inp.tgt_count,
                              src_count=src_count)
        per_tile = ((-(-n // unroll) * unroll * valid).sum(1)
                    * tile).double().tolist()
        tile_major = [per_tile[r] if y < tiles[r] else 0.0
                      for y in range(grid) for r in range(b)]
        order = sorted(range(b), key=lambda r: -per_tile[r])
        sorted_rows = [per_tile[r] if y < tiles[r] else 0.0
                       for r in order for y in range(grid)]
        print(f"{lane}: needed {needed:.4e} pairs, swept {geo['pairs']:.4e}"
              f" ({geo['pairs'] / needed:.3f}x), {geo['tiles']} of "
              f"{geo['tiles_launched']} tiles hold a target; makespan / "
              f"ideal: tile-major {makespan_ratio(tile_major, args.slots):.4f},"
              f" rows sorted heaviest first "
              f"{makespan_ratio(sorted_rows, args.slots):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

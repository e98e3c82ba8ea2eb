#!/usr/bin/env python3
"""Time the ranged modified-charge kernel at several chunk sizes on one GPU.

    python3 tools/mc_chunk_sweep.py [--n 1000000] [--chunks 512,1024,...]

Plans the paper's Fig. 4 setting (theta 0.7, degree 8, N_L = N_B = 2000,
f32) at N points uniform in [-1,1]^3, then, for each chunk size P, cuts
the plan's node ranges into chunks of at most P particles and times
`ops.modified_charges_ranged` on them (CUDA events, median of 20 calls).
Each size is checked against the plan's own chunk table (rtol 3e-3, atol
3e-4 max|q_hat|). Prints one line per size and the card's name and power
limit; needs a CUDA device.
"""
import argparse
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.configs.bltc import fig4
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--chunks", default="512,1024,2048,4096,8192")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mc_chunk_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = fig4(theta=0.7, degree=8)
    rng = np.random.default_rng(2020)
    x = rng.uniform(-1, 1, (args.n, 3)).astype(np.float32)
    q = torch.as_tensor(rng.uniform(-1, 1, args.n).astype(np.float32),
                        device=dev)
    plan = TreecodeSolver(cfg).plan(x)
    a = plan.arrays
    q_sorted = q[a["src_perm"]]
    base = (a["src_sorted"], q_sorted)
    box = (a["node_lo"], a["node_hi"])
    kw = dict(degree=cfg.degree, backend="cuda")
    want = ops.modified_charges_ranged(*base, a["mc_chunks"],
                                       a["mc_chunk_ptr"], *box, **kw)
    atol = 3e-4 * want.abs().max().item()
    start, count = ev.node_ranges({k: (tuple(t.cpu().numpy() for t in v)
                                       if isinstance(v, tuple)
                                       else v.cpu().numpy())
                                   for k, v in a.items()
                                   if k in ("node_lo", "bucket_gather",
                                            "bucket_nodes")})
    print(f"# {smi}; N={args.n}, {len(count)} nodes, "
          f"{int(count.sum())} particle-levels", flush=True)
    for p in (int(s) for s in args.chunks.split(",")):
        chunks, ptr = (torch.as_tensor(t, device=dev)
                       for t in mcm.chunk_table(start, count, p))

        def call():
            return ops.modified_charges_ranged(*base, chunks, ptr, *box, **kw)

        got = call()
        err = (got - want).abs()
        assert bool((err <= atol + 3e-3 * want.abs()).all()), p
        for _ in range(3):
            call()
        times = []
        for _ in range(20):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            call()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        print(f"P={p}: {chunks.shape[0]} chunks, median "
              f"{statistics.median(times):.4f} ms (min {min(times):.4f}), "
              f"max abs err vs P={mcm.CHUNK} {err.max().item():.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

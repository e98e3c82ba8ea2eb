"""Treecode serving launcher: the batched ensemble evaluation service.

Drives `repro_torch.serve.ServeFrontend` with a stream of synthetic
mixed-shape requests and prints the service counters: a quick end-to-end
check that mixed particle counts bucket into few shape classes and that
warm buckets never recompile:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \\
        --max-batch 8 --sizes 96,128,180 --kernel yukawa

It runs on the CUDA device; ``--device cpu`` runs the plain PyTorch path.
The flags of the LM prefill/decode skeleton this entry point replaced
(--arch, --prompt-len, --new-tokens, ...) exit with a pointer here. Exits
non-zero on any retrace.
"""
import argparse
import sys
import time

import numpy as np

_REMOVED_FLAGS = ("--arch", "--smoke", "--mesh", "--prompt-len",
                  "--new-tokens")


def _reject_removed_flags(argv):
    hit = [f for f in _REMOVED_FLAGS
           if any(a == f or a.startswith(f + "=") for a in argv)]
    if hit:
        raise SystemExit(
            f"{' '.join(hit)}: the LM-serving skeleton was removed; this "
            "entry point serves the treecode ensemble service (see the "
            "module docstring for its flags)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    _reject_removed_flags(argv)
    ap = argparse.ArgumentParser(
        description="batched treecode evaluation service (smoke run)")
    ap.add_argument("--requests", type=int, default=32,
                    help="number of synthetic requests to submit")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="ensemble width each bucket packs into")
    ap.add_argument("--sizes", default="96,128,180",
                    help="comma-separated particle counts to cycle over")
    ap.add_argument("--kernel", default="coulomb")
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--theta", type=float, default=0.7)
    ap.add_argument("--leaf-size", type=int, default=32)
    ap.add_argument("--deadline", type=float, default=0.05,
                    help="flush deadline in seconds")
    ap.add_argument("--forces", action="store_true",
                    help="request forces with every evaluation")
    ap.add_argument("--device", default="cuda",
                    help="where the plans run: cuda (default) or cpu")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="enable phase-span tracing and write a "
                         "Chrome-trace/Perfetto JSON file here")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.core.api import TreecodeConfig
    from repro_torch.serve import ServeFrontend

    if args.trace:
        obs.enable()

    sizes = [int(s) for s in args.sizes.split(",") if s]
    cfg = TreecodeConfig(kernel=args.kernel, degree=args.degree,
                         theta=args.theta, leaf_size=args.leaf_size)
    fe = ServeFrontend(cfg, max_batch=args.max_batch,
                       flush_deadline=args.deadline, device=args.device)

    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    futs = []
    for i in range(args.requests):
        n = sizes[i % len(sizes)]
        futs.append(fe.submit(rng.random((n, 3)), rng.standard_normal(n),
                              forces=args.forces))
    fe.flush()                       # drain stragglers
    for f in futs:
        f.result()
    wall = time.monotonic() - t0

    s = fe.stats()
    print(f"served {s['requests']} requests in {wall:.2f} s "
          f"({s['requests'] / wall:.1f} req/s) on {fe.device} across "
          f"{s['num_buckets']} buckets / {s['flushes']} flushes")
    print(f"compiles={s['compiles']} retraces={s['retraces']} "
          f"capacity_grows={s['capacity_grows']} "
          f"occupancy_mean={s['occupancy_mean']:.2f}")
    print(f"latency p50={s['latency_p50'] * 1e3:.1f} ms "
          f"p99={s['latency_p99'] * 1e3:.1f} ms")
    if args.trace:
        obs.write_chrome_trace(args.trace, process_name="repro_torch.serve")
        totals = obs.phase_totals("serve.")
        print("phases (ms): " + ", ".join(
            f"{k.split('.', 1)[1]}={v:.1f}" for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])))
        print(f"wrote {args.trace}")
    if s["retraces"]:
        raise SystemExit("retraces detected: warm buckets recompiled")


if __name__ == "__main__":
    main()

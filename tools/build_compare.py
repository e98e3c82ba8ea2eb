#!/usr/bin/env python3
"""nvcc seconds of the kernel libraries of this checkout beside another's.

    python3 tools/build_compare.py --parent DIR

Builds the four base libraries (`kernels._build.SOURCES`) of this
checkout and of the checkout at DIR (e.g. the commit before, unpacked
with `git archive` under the git-ignored `build/`) into fresh
directories, all eight nvcc processes started together as
`chip_smoke.py` starts its own, and prints each library's seconds, its
kernels' registers and spills, and the size of its library. Needs nvcc
(the machine with the card); runs nothing on the card.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    from chip_smoke import ptxas_usage
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    trees = {"parent": os.path.join(args.parent, "src", "repro_torch",
                                    "kernels", "csrc"),
             "this": str(_build.CSRC)}
    out = tempfile.mkdtemp(prefix="build_compare_")
    procs, t0 = {}, time.perf_counter()
    for tree, csrc in trees.items():
        for name in _build.SOURCES:
            lib = os.path.join(out, f"{tree}_{name}.so")
            procs[tree, name] = (subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                 os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    def finish(proc):
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0

    # each nvcc's output drained, and its end timed, on a thread of its own
    with ThreadPoolExecutor(len(procs)) as pool:
        done = {key: pool.submit(finish, proc)
                for key, (proc, _) in procs.items()}
    for (tree, name), (proc, lib) in procs.items():
        log, secs = done[tree, name].result()
        assert proc.returncode == 0, log
        usage = ptxas_usage(log)
        spills = sum(1 for v in usage.values() if v[1] or v[2])
        print(f"{tree:6s} {name}: {secs:.1f} s (ended), "
              f"{len(usage)} kernels, "
              f"{min(v[0] for v in usage.values())}-"
              f"{max(v[0] for v in usage.values())} registers, {spills} "
              f"spill, {os.path.getsize(lib) / 2 ** 20:.2f} MiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

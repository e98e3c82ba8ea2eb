#!/usr/bin/env python3
"""Time build variants of the modified-charge kernel on one GPU.

    python3 tools/mc_variants.py [--n 1000000]

Each variant is `src/repro_torch/kernels/csrc/modified_charges.cu` with
one text substitution (the blocks per SM asked of `__launch_bounds__`,
the unroll of the stage-2 particle loop), built with the port's nvcc
flags into `build/mc_variants/`. On the paper's Fig. 4 plan (theta 0.7,
degree 8, N_L = N_B = 2000, f32) at N uniform points, every variant runs
the plan's chunk table, is held against the committed kernel bitwise
where only the schedule changes (else at rtol 3e-3, atol 3e-4
max|q_hat|), and is timed with CUDA events (median of 20 calls, in the
order given and then reversed). Prints the registers and spills of the
f32 n+1 = 9 instantiation and the card's name and power limit.
"""
import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

BOUNDS = "__launch_bounds__(Geo<T, N1>::THREADS)"
UNROLL = "#pragma unroll 2\n      for (int j = g; j < cnt; j += G::GROUPS)"
VARIANTS = {  # name: [(old, new), ...] applied to the committed source
    "committed": [],
    "min_blocks_3": [(BOUNDS, "__launch_bounds__(Geo<T, N1>::THREADS, 3)")],
    "min_blocks_4": [(BOUNDS, "__launch_bounds__(Geo<T, N1>::THREADS, 4)")],
    "unroll_4": [(UNROLL, UNROLL.replace("unroll 2", "unroll 4"))],
    "min_blocks_3_unroll_4": [
        (BOUNDS, "__launch_bounds__(Geo<T, N1>::THREADS, 3)"),
        (UNROLL, UNROLL.replace("unroll 2", "unroll 4"))],
}


def build_all(out_dir):
    """{variant: (library path, nvcc log)}, all nvcc processes at once."""
    from repro_torch.kernels import _build
    src = open(_build.CSRC / "modified_charges.cu").read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        assert p.returncode == 0, log
        out[name] = (lib, log)
    return out


def main() -> int:
    import numpy as np
    import torch
    from chip_smoke import event_ms, ptxas_usage, smi_line
    from repro_torch.configs.bltc import fig4
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mc_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_all(os.path.join(ROOT, "build", "mc_variants"))
    dev = torch.device("cuda", 0)
    cfg = fig4(theta=0.7, degree=8)
    rng = np.random.default_rng(2020)
    x = rng.uniform(-1, 1, (args.n, 3)).astype(np.float32)
    q = torch.as_tensor(rng.uniform(-1, 1, args.n).astype(np.float32),
                        device=dev)
    a = TreecodeSolver(cfg).plan(x).arrays
    mc_args = (a["src_sorted"], q[a["src_perm"]], a["mc_chunks"],
               a["mc_chunk_ptr"], a["node_lo"], a["node_hi"])
    print(f"# {smi_line()}; N={args.n}, {a['mc_chunks'].shape[0]} chunks",
          flush=True)
    calls = {}
    for name, (path, log) in libs.items():
        lib = ctypes.CDLL(path)
        for fn, argtypes in mcm._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        # the committed wrapper, pointed at this variant's library
        mcm._build._LIBS["modified_charges"] = lib
        calls[name] = lib
        use = [v for k, v in ptxas_usage(log).items()
               if "mc_chunk_kernelIfLi9E" in k]
        print(f"{name}: f32 n+1=9 (registers, spill stores, spill loads) "
              f"{use[0] if use else 'not found'}", flush=True)

    def run(name):
        mcm._build._LIBS["modified_charges"] = calls[name]
        return ops.modified_charges_ranged(*mc_args, degree=cfg.degree,
                                           backend="cuda")

    want = run("committed")
    atol = 3e-4 * want.abs().max().item()
    times = {name: [] for name in libs}
    for order in (list(libs), list(reversed(list(libs)))):
        for name in order:
            got = run(name)
            same = torch.equal(got, want)
            assert bool(((got - want).abs() <= atol + 3e-3 * want.abs())
                        .all()), name
            times[name].append((event_ms(lambda: run(name), 20), same))
    for name, ts in times.items():
        print(f"{name}: {' / '.join(f'{t:.4f}' for t, _ in ts)} ms "
              f"(median of 20, forward / reversed order); bitwise equal to "
              f"the committed kernel: {ts[0][1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time build variants of the modified-charge kernels on one GPU.

    python3 tools/mc_variants.py [--n 1000000] [--runtime]

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

With --runtime, the runtime-degree kernels (n+1 >= 16) instead. Each
variant patches constants of the source: another f64 tensor-core shape
for the forward (`McMma`: m16n8k4, m16n8k16, m8n8k4; committed m16n8k8)
or the transpose (`MctMma`: m8n8k4; committed m16n8k4; the k8 and k16
shapes' tables do not fit there at n+1 = 17), the mma wrappers of the
shapes the source lacks inserted with them; f64 on the FFMA kernels
(`kTensorCores`); the forward's particles a tile (`kMmaMaxTile` 64);
the transpose's staged columns (`kTmmaCols` 64), its n-tile unroll
(`kTmmaUnroll` 1), four warps of two m-tiles or of one (committed:
eight warps of one); or the rows divided with the IEEE division's own code (its
slow-path branch in every division) instead of `div_fast`. Each
variant's tables fit at n+1 = 17, so its f64 kernels run on the tensor
cores but for `ffma`. On phase 21b's plan (the Fig. 4 points at N, f64, degree
16) the forward runs the plan's chunk table and the transpose its tile
table on a seeded q_hat cotangent; each variant is held against the
committed kernels at 21b's rules (the forward rtol 1e-10, atol 1e-12 max|q_hat|;
the transpose per entry within 1e-13 of its sum of the terms'
magnitudes) and timed as above; and the f32 forward forced at n+1 = 9
(the FFMA kernel) on a Fig. 4 plan (uniform points at N, f32, degree
8), held to the template at phase 4's rule (rtol 3e-3, atol
3e-4 max|q_hat|) and timed beside it. Prints the runtime kernels'
registers and spills.
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


FWD_MMA = "using McMma = MmaF64<16, 8>;"
T_MMA = "using MctMma = MmaF64<16, 4>;"
#: The f64 mma shapes the source does not use, inserted before `MmaF64`.
MMA_ANCHOR = "template <int MR, int KD>\nstruct MmaF64 {"
MMA_M8N8K4 = """__device__ __forceinline__ void mma_f64(double (&c)[2], const double (&a)[1],
                                        const double (&b)[1]) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a[0]), "d"(b[0]));
}
"""
MMA_M16N8K16 = """__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
"""


def shape(line, rows, k, extra=""):
    """The substitutions that set one kernel's shape (`line` its alias)."""
    subs = [(line, line.replace("<16, 8>", f"<{rows}, {k}>")
             .replace("<16, 4>", f"<{rows}, {k}>"))]
    if extra:
        subs.append((MMA_ANCHOR, extra + "\n" + MMA_ANCHOR))
    return subs


def const(decl, value):
    """The substitution of `constexpr int <decl> = ...;`'s value."""
    return (decl, decl.split(" = ")[0] + f" = {value};")


TMMA_THREADS = "constexpr int kTmmaThreads = 256;"
TMMA_MTW = "constexpr int kTmmaMtw = 16 / MctMma::ROWS;"
RT_VARIANTS = {
    "committed": [],
    "fwd_m16n8k4": shape(FWD_MMA, 16, 4),
    "fwd_m16n8k16": shape(FWD_MMA, 16, 16, MMA_M16N8K16),
    "fwd_m8n8k4": shape(FWD_MMA, 8, 4, MMA_M8N8K4),
    "t_m8n8k4": shape(T_MMA, 8, 4, MMA_M8N8K4),
    "ffma": [("constexpr bool kTensorCores = std::is_same<T, double>::value;",
              "constexpr bool kTensorCores = false;")],
    "kt64": [const("constexpr int kMmaMaxTile = 128;", 64)],
    "cols64": [const("constexpr int kTmmaCols = 128;", 64)],
    "unroll1": [const("constexpr int kTmmaUnroll = 2;", 1)],
    "warps4_mtw2": [const(TMMA_THREADS, 128), const(TMMA_MTW, 2)],
    "warps4_mtw1": [const(TMMA_THREADS, 128), const(TMMA_MTW, 1)],
    "ieee_div": [("const T v = div_fast(w[k], d);",
                  "const T v = w[k] / d;")],
}


def build_all(out_dir, variants=VARIANTS):
    """{variant: (library path, nvcc log)}, all nvcc processes at once."""
    from repro_torch.kernels import _build
    src = open(_build.CSRC / "modified_charges.cu").read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
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


def bind(path):
    """The library at `path` with the wrapper's signatures."""
    from repro_torch.kernels import modified_charges as mcm
    lib = ctypes.CDLL(path)
    for fn, argtypes in mcm._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def runtime_main(n) -> int:
    """The runtime-degree kernels' variants at n+1 = 17, f64 (21b's plan)."""
    import dataclasses

    import numpy as np
    import torch
    from chip_smoke import (HIGH_DEGREE, event_ms, fig4_config, kernel_name,
                            ptxas_usage, smi_line)
    from repro_torch.core import cheby
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    libs = build_all(os.path.join(ROOT, "build", "mc_rt_variants"),
                     RT_VARIANTS)
    dev = torch.device("cuda", 0)
    degree, n1 = HIGH_DEGREE, HIGH_DEGREE + 1
    cfg = dataclasses.replace(fig4_config(), degree=degree, dtype="float64")
    rng = np.random.default_rng(2020)               # 21b's points
    x = rng.uniform(-1, 1, (n, 3))
    q = torch.as_tensor(rng.uniform(-1, 1, n), device=dev)
    a = TreecodeSolver(cfg).plan(x).arrays
    inp = ev.kernel_inputs(a, q, degree=degree)
    mc_args = (a["src_sorted"], inp.q_sorted, a["mc_chunks"],
               a["mc_chunk_ptr"], a["node_lo"], a["node_hi"])
    tiles, chain = mcm.tile_table(a["mc_chunks"], a["parent_of"],
                                  len(a["bucket_nodes"]),
                                  a["src_sorted"].shape[0])
    qhat_bar = torch.as_tensor(np.random.default_rng(2122).uniform(
        -1, 1, (a["node_lo"].shape[0], n1 ** 3)), device=dev)
    mct_args = (a["src_sorted"], qhat_bar, tiles, chain, a["node_lo"],
                a["node_hi"])
    print(f"# {smi_line()}; N={n}, f64, n+1={n1}, "
          f"{a['mc_chunks'].shape[0]} chunks, {tiles.shape[0]} tiles",
          flush=True)
    calls = {}
    for name, (path, log) in libs.items():
        calls[name] = bind(path)
        use = {name: v for k, v in ptxas_usage(log).items()
               if "_rt_" in (name := kernel_name(k))}
        print(f"{name}: (registers, spill stores, spill loads) "
              + "; ".join(f"{k} {v}" for k, v in sorted(use.items())),
              flush=True)

    def fwd(name):
        mcm._build._LIBS["modified_charges"] = calls[name]
        return ops.modified_charges_ranged(*mc_args, degree=degree,
                                           backend="cuda")

    def tr(name):
        mcm._build._LIBS["modified_charges"] = calls[name]
        return ops.modified_charges_transpose_ranged(*mct_args, degree=degree,
                                                     backend="cuda")

    cfg9 = fig4_config()                             # phase 4's plan, f32
    x9 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    q9 = torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32),
                         device=dev)
    a9 = TreecodeSolver(cfg9).plan(x9).arrays
    inp9 = ev.kernel_inputs(a9, q9, degree=cfg9.degree)
    args9 = (a9["src_sorted"], inp9.q_sorted, a9["mc_chunks"].int(),
             a9["mc_chunk_ptr"].int(),
             ops._cluster_nodes(a9["node_lo"], a9["node_hi"],
                                cfg9.degree).contiguous(),
             cheby.bary_weights_1d(cfg9.degree, torch.float32, dev),
             cfg9.degree)

    def f32_forced(name, runtime=True):
        mcm._build._LIBS["modified_charges"] = calls[name]
        return mcm.modified_charges_ranged_cuda(*args9, _runtime=runtime)

    template = f32_forced("committed", runtime=False)
    atol9 = 3e-4 * template.abs().max().item()
    want_f, want_t = fwd("committed"), tr("committed")
    atol = 1e-12 * want_f.abs().max().item()
    mag = mcm.modified_charges_transpose_ranged_plain(*mct_args, degree,
                                                      magnitude=True)
    times = {name: [] for name in libs}
    for order in (list(libs), list(reversed(list(libs)))):
        for name in order:
            got_f, got_t = fwd(name), tr(name)
            assert bool(((got_f - want_f).abs() <= atol + 1e-10
                         * want_f.abs()).all()), f"{name}: forward"
            assert bool(((got_t - want_t).abs() <= 1e-13 * mag).all()), \
                f"{name}: transpose"
            got9 = f32_forced(name)
            assert bool(((got9 - template).abs() <= atol9 + 3e-3
                         * template.abs()).all()), f"{name}: f32 n+1 = 9"
            times[name].append((event_ms(lambda: fwd(name), 10),
                                event_ms(lambda: tr(name), 10),
                                event_ms(lambda: f32_forced(name), 10)))
    t9 = event_ms(lambda: f32_forced("committed", runtime=False), 10)
    for name, ts in times.items():
        print(f"{name}: forward {' / '.join(f'{t[0]:.4f}' for t in ts)} ms, "
              f"transpose {' / '.join(f'{t[1]:.4f}' for t in ts)} ms "
              f"(median of 10, forward / reversed order); f32 forward "
              f"forced at n+1 = 9 {' / '.join(f'{t[2]:.4f}' for t in ts)} "
              f"ms (the template {t9:.4f})", flush=True)
    return 0


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
    ap.add_argument("--runtime", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mc_variants: no CUDA device", file=sys.stderr)
        return 2
    if args.runtime:
        return runtime_main(args.n)
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
        lib = bind(path)
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

#!/usr/bin/env python3
"""Time build variants of the transposed modified-charge kernel on one GPU.

    python3 tools/mct_variants.py [--n 1000000] [--only NAME ...]

Each variant is `src/repro_torch/kernels/csrc/modified_charges.cu` built
with other values of its knobs (`-D` flags): MCT_TILE (particles per
tile, one block each; the tile table is cut to the same size), MCT_P
(particles per thread; 0: the source's rule) and MCT_REGS (the registers
a thread may take, which sets the blocks per SM asked of
`__launch_bounds__`); or with a text substitution. nvcc takes the port's
flags and writes into `build/mct_variants/`. "compact" runs the
committed build on the tile table with its empty rows dropped (a host
read). "diag_*" variants change the arithmetic to show where the time
goes (divisions made multiplications; rows of differences only), so they
are timed but not held to anything. On the paper's Fig. 4 plan (theta
0.7, degree 8, N_L = N_B = 2000, f32) at N uniform points, with a seeded
q_hat cotangent, every other variant is held against the plain version
(each particle within MCT_K times its sum of the terms' magnitudes, as
`chip_smoke.py` phase 14) and compared bitwise with the committed build.
All are timed in turns on one card: CUDA events over 20 launches of the
wrapper back to back (the device time per launch), and a call alone
(median of 20), in the order given and then reversed; then the committed
build (and the parent) over 3000 launches while nvidia-smi samples the
SM clock and power. Prints the registers and spills of the f32 n+1 = 9
instantiation and the card's name and power limit.

With ``--parent DIR`` (a checkout of the commit before the tile kernel,
e.g. unpacked with `git archive` under the git-ignored `build/`) the
earlier design runs in the same turns as "parent": its source from DIR,
its two launches (a block per chunk into a (levels, N) scratch, then
the levels added in order) called through its own C entry, each chunk's
tree level from the plan's buckets as that commit took them; it is held
to the same bar and compared bitwise with the committed kernel.
"""
import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

ROWS = "const T d{i} = bary_row<T, N1>(y{i}[i], sn{o}, sW, t{r});"
KERNEL = ("template <typename T, int N1>\n"
          "__global__ void __launch_bounds__(TGeo")
CHEAP = """template <typename T, int N1>
__device__ __forceinline__ T cheap_row(T y, const T* s, T* t) {
  T den = T(0);
#pragma unroll
  for (int k = 0; k < N1; ++k) {
    t[k] = y - s[k];
    den += t[k];
  }
  return den;
}

""" + KERNEL
# rows of differences only (no division, no hit test)
CHEAP_ROWS = [(ROWS.format(i=i, o=o, r=r),
               f"const T d{i} = cheap_row<T, N1>(y{i}[i], sn{o}, t{r});")
              for i, o, r in ((1, "", ""), (2, " + N1", "2[i]"),
                              (3, " + 2 * N1", "3[i]"))] + [(KERNEL, CHEAP)]
DIV = "t[k] = w[k] / d;"
VARIANTS = {  # name: (MCT_TILE, MCT_P, MCT_REGS, options)
    "committed": None,
    "compact": (None, None, None, {"compact": True}),
    "p4_regs160": (256, 4, 160, {}),
    "p2_regs128": (256, 2, 128, {}),
    "p2_regs85": (256, 2, 85, {}),
    "p2_t128": (128, 2, 100, {}),
    "p2_t512": (512, 2, 100, {}),
    "p3_t384_regs128": (384, 3, 128, {}),
    "p1_t128_regs64": (128, 1, 64, {}),
    "diag_mul": (256, 0, 100, {"subs": [(DIV, "t[k] = w[k] * d;")]}),
    "diag_cheap_rows": (256, 0, 100, {"subs": CHEAP_ROWS}),
}
BURST = 20


def build_all(out_dir, names, parent=None):
    """{variant: (library path, nvcc log, tile)}, all nvcc processes at
    once (the parent's tile: None)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import modified_charges as mcm
    src = str(_build.CSRC / "modified_charges.cu")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    if parent:
        lib = os.path.join(out_dir, "libparent.so")
        procs["parent"] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(parent, "src", "repro_torch", "kernels", "csrc",
                          "modified_charges.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            None)
    text = open(src).read()
    for name in names:
        knobs = VARIANTS[name]
        if knobs is not None and knobs[0] is None:    # the committed build's
            continue
        if knobs is None:                             # the committed build
            flags, subs, tile = [], [], mcm.TILE
        else:
            flags = [f"-DMCT_TILE={knobs[0]}", f"-DMCT_P={knobs[1]}",
                     f"-DMCT_REGS={knobs[2]}"]
            subs, tile = knobs[3].get("subs", []), knobs[0]
        cu = src
        if subs:
            body = text
            for old, new in subs:
                assert body.count(old) == 1, (name, old)
                body = body.replace(old, new)
            cu = os.path.join(out_dir, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(body)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            tile)
    out = {}
    for name, (p, lib, tile) in procs.items():
        log, _ = p.communicate()
        assert p.returncode == 0, log
        out[name] = (lib, log, tile)
    return out


def main() -> int:
    import numpy as np
    import torch
    from chip_smoke import (MCT_K, event_ms, ptxas_usage, smi_line,
                            smi_sampler, smi_samples, timed)
    from repro_torch.configs.bltc import fig4
    from repro_torch.core import cheby
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to build (committed always runs)")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the commit before the tile kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mct_variants: no CUDA device", file=sys.stderr)
        return 2
    names = ["committed"] + [n for n in (args.only or VARIANTS)
                             if n != "committed"]
    libs = build_all(os.path.join(ROOT, "build", "mct_variants"), names,
                     args.parent)
    dev = torch.device("cuda", 0)
    cfg = fig4(theta=0.7, degree=8)
    degree, n1 = cfg.degree, cfg.degree + 1
    rng = np.random.default_rng(2020)
    x = rng.uniform(-1, 1, (args.n, 3)).astype(np.float32)
    a = TreecodeSolver(cfg).plan(x).arrays
    qhat_bar = torch.as_tensor(
        rng.uniform(-1, 1, (a["node_lo"].shape[0], n1 ** 3)).astype(
            np.float32), device=dev)
    levels, n = len(a["bucket_nodes"]), a["src_sorted"].shape[0]
    # the parent's inputs: the mapped nodes and the weights
    nodes = ops._cluster_nodes(a["node_lo"], a["node_hi"], degree)
    w = cheby.bary_weights_1d(degree, torch.float32, dev)
    tables = {tile: mcm.tile_table(a["mc_chunks"], a["parent_of"], levels,
                                   n, tile=tile)
              for tile in sorted({t for _, _, t in libs.values() if t})}
    tiles, chain = tables[mcm.TILE]
    keep = tiles[:, 0] < tiles[:, 1]                  # a host read
    compact = (tiles[keep].contiguous(), chain[keep].contiguous())
    print(f"# {smi_line()}; N={args.n}, {a['mc_chunks'].shape[0]} chunks, "
          f"{levels} levels", flush=True)
    calls = {}
    for name, (path, log, tile) in libs.items():
        lib = ctypes.CDLL(path)
        if name == "parent":
            fn = lib.mct_eval_f32
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            calls[name] = (lib, None)
            use = [v for k, v in ptxas_usage(log).items()
                   if "mct_chunk_kernelIfLi9E" in k]
            print(f"parent: chunk kernel f32 n+1=9 (registers, spill "
                  f"stores, spill loads) {use[0] if use else 'not found'}",
                  flush=True)
            continue
        for fn, argtypes in mcm._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        assert lib.mct_tile() == tile, (name, lib.mct_tile(), tile)
        calls[name] = (lib, tile)
        use = [v for k, v in ptxas_usage(log).items()
               if "mct_tile_kernelIfLi9E" in k]
        print(f"{name}: tile {tile}; f32 n+1=9 (registers, spill stores, "
              f"spill loads) {use[0] if use else 'not found'}", flush=True)
    for name in names:
        if VARIANTS[name] is not None and VARIANTS[name][0] is None:
            calls[name] = calls["committed"]

    chunks = a["mc_chunks"]
    level = torch.zeros(a["node_lo"].shape[0], dtype=torch.int32, device=dev)
    for lvl, ids in enumerate(a["bucket_nodes"]):
        level[ids.long()] = lvl
    level = level[chunks[:, 0].long()].contiguous()
    partial = torch.empty((levels, n), dtype=torch.float32, device=dev)

    def run_parent(lib):
        out = torch.empty((n,), dtype=torch.float32, device=dev)
        rc = lib.mct_eval_f32(
            a["src_sorted"].data_ptr(), qhat_bar.data_ptr(),
            nodes.data_ptr(), w.data_ptr(), chunks.data_ptr(),
            level.data_ptr(), partial.data_ptr(), out.data_ptr(),
            chunks.shape[0], levels, n1, n,
            torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, rc
        return out

    def options(name):
        return {} if VARIANTS.get(name) is None else VARIANTS[name][3]

    def run(name):
        lib, tile = calls[name]
        if tile is None:
            return run_parent(lib)
        mcm._build._LIBS["modified_charges"] = lib   # the committed wrapper
        t, c = compact if options(name).get("compact") else tables[tile]
        return mcm.modified_charges_transpose_ranged_cuda(
            a["src_sorted"], qhat_bar, t, c, a["node_lo"], a["node_hi"],
            degree)

    plain = (a["src_sorted"], qhat_bar, tiles, chain, a["node_lo"],
             a["node_hi"], degree)
    want = mcm.modified_charges_transpose_ranged_plain(*plain)
    mag = mcm.modified_charges_transpose_ranged_plain(*plain, magnitude=True)
    ref = run("committed")
    k = MCT_K[4]
    times = {name: [] for name in calls}
    for order in (list(calls), list(reversed(list(calls)))):
        for name in order:
            got = run(name)
            err = (got - want).abs()
            assert name.startswith("diag") or (
                torch.isfinite(got).all() and not (err > k * mag).any()), name
            _, ms = timed(lambda: [run(name) for _ in range(BURST)])
            times[name].append((ms / BURST, torch.equal(got, ref),
                                event_ms(lambda: run(name), 20)))
    clocks = {}
    for name in [n for n in ("parent", "committed") if n in calls]:
        run(name)
        torch.cuda.synchronize()
        sampler = smi_sampler()                  # ~1 s of launches
        try:
            _, ms = timed(lambda: [run(name) for _ in range(3000)])
        finally:
            clocks[name] = (smi_samples(sampler), ms / 3000)
    for name, ts in times.items():
        print(f"{name}: {' / '.join(f'{t:.4f}' for t, _, _ in ts)} ms a "
              f"launch ({BURST} back to back, forward / reversed order), "
              f"{' / '.join(f'{t:.4f}' for _, _, t in ts)} ms a call alone "
              f"(median of 20); "
              + ("diagnostic, not held" if name.startswith("diag") else
                 f"bitwise equal to the committed kernel: {ts[0][1]}"),
              flush=True)
    for name, (smp, ms) in clocks.items():
        seen = ("not sampled" if smp is None else
                f"{smp[0]:.0f} MHz, {smp[1]:.1f} W ({smp[2]} samples)")
        print(f"{name} over 3000 launches back to back ({ms:.4f} ms a "
              f"launch): median SM clock and power {seen}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time build variants of the two field kernels on one GPU.

    python3 tools/field_variants.py [--n 1000000] [--rows 64]

Each variant is a committed field source with text substitutions, built
with the port's nvcc flags into `build/field_variants/`:

- the direct lane's generic kernel (`csrc/batch_cluster_field.cu`): the
  blocks per SM asked of `__launch_bounds__`, the targets per lane,
  "predicated" (every pair behind the r^2 predicate, as if every chunk
  held a target) and "flat" (pairs added straight into one sum per
  target for the whole row instead of per-slot sums);
- the approximation lane's grid kernel (`csrc/batch_cluster_field_grid.cu`,
  built for n+1 = 9 only): the targets per lane, the blocks per SM, the
  row loop's unroll, "predicated", and "soft" (a software reciprocal
  square root on the FMA pipe for 1, 2 or 3 of each row's 9 pairs, the
  rest on the MUFU).

On the paper's Fig. 4 plan (theta 0.7, degree 8, N_L = N_B = 2000, f32,
Coulomb) at N uniform points, each variant runs its lane's inputs as the
force evaluation gives them (`eval.lane_inputs`), is timed with CUDA
events (median of 5 calls, in the order given and then reversed), and is
held against the plain version on the first `--rows` batch rows (each
gradient entry against its sum of the terms' magnitudes, the rule of
`chip_smoke.py`). Prints each variant's registers and spills and SASS
instructions a pair of its f32 Coulomb instantiation (free space; at
n+1 = 9 for the grid kernel), and the card's name and power limit.
"""
import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

_BOUNDS = "return dtype_size == 4 ? 6 : 3;"
_SLOT = """  for (int s = 0; s < S; ++s) {
    const int c = row[s];  // the same for every thread: uniform branch
    Field<T> slot[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) zero(slot[r]);
"""
_FLAT = """  Field<T> slot[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) zero(slot[r]);
  for (int s = 0; s < S; ++s) {
    const int c = row[s];  // the same for every thread: uniform branch
"""
_FOLD = """    // the slot's sums into this warp's totals, once a slot (a lane owns
    // its targets' entries: no barrier)
"""
_PER = "sizeof(T) == 4 && N1 <= 9 ? 2 : 1;"
_GRID_BOUNDS = "MIN_BLOCKS = sizeof(T) == 4 ? 5 : 3;"


def _grid_blocks(n):
    return [(_GRID_BOUNDS, f"MIN_BLOCKS = sizeof(T) == 4 ? {n} : 3;")]
_ROW = "#pragma unroll\n    for (int k2 = 0;"
# every pair behind the r^2 predicate, as if each chunk or plane could
# hold an exact hit
_PREDICATED = [("        if (clear)\n          sweep",
                "        if (false)\n          sweep")]
# a software reciprocal square root (3 Newton steps from the bit-level
# first guess, ~12 fp32 and integer instructions on the FMA and ALU
# pipes) for the pairs k3 of each row that `soft` selects, the rest on
# the MUFU: tests whether the SFU is what the grid kernel waits on
_NEWTON = """__device__ __forceinline__ float rsqrt_newton(float x) {
  float y = __int_as_float(0x5f375a86 - (__float_as_int(x) >> 1));
  const float h = 0.5f * x;
  y = y * fmaf(-h * y, y, 1.5f);
  y = y * fmaf(-h * y, y, 1.5f);
  return y * fmaf(-h * y, y, 1.5f);
}
__device__ __forceinline__ double rsqrt_newton(double x) { return x; }

// One grid pair:"""
_CALL = "kp, sp[r], rs, sz[r]);"


def _soft(pick):
    return [("// One grid pair:", _NEWTON),
            ("T& row, T& gz) {", "T& row, T& gz, bool soft = false) {"),
            ("const float rinv = rsqrt_ftz(r2);",
             "const float rinv = soft ? rsqrt_newton(r2) : rsqrt_ftz(r2);"),
            (_CALL, _CALL.replace("sz[r]);", f"sz[r], {pick});"))]


#: {source: {variant: [(old, new), ...]}}, applied to the committed text
VARIANTS = {
    "batch_cluster_field": {
        "committed": [],
        "min_blocks_8": [(_BOUNDS, "return dtype_size == 4 ? 8 : 3;")],
        "min_blocks_5": [(_BOUNDS, "return dtype_size == 4 ? 5 : 3;")],
        "per_thread_2": [("kPerThread = 4;", "kPerThread = 2;")],
        "per_thread_2_min_blocks_8": [
            ("kPerThread = 4;", "kPerThread = 2;"),
            (_BOUNDS, "return dtype_size == 4 ? 8 : 3;")],
        "predicated": _PREDICATED,
        # one sum per target over the whole row (the slot loop's sums are
        # declared once and folded into the totals after the loop)
        "flat": [(_SLOT, _FLAT), (_FOLD, "  }\n  {\n")],
    },
    "batch_cluster_field_grid": {
        "committed": [],
        "per_1": [(_PER, "1;")],
        "min_blocks_8": _grid_blocks(8),
        "min_blocks_6": _grid_blocks(6),
        "min_blocks_4": _grid_blocks(4),
        "row_unroll_3": [(_ROW, _ROW.replace("unroll", "unroll 3"))],
        "min_blocks_6_row_unroll_3": _grid_blocks(6) + [
            (_ROW, _ROW.replace("unroll", "unroll 3"))],
        "predicated": _PREDICATED,
        "soft_1_of_9": _soft("k3 == 0"),
    },
}
#: Substitutions every variant of a source takes: the grid kernel's
#: variants build the main path's n+1 = 9 only (the full set of 14 takes
#: minutes an nvcc), as (old, new, occurrences).
RESTRICT = {"batch_cluster_field_grid": [("kMaxN1 = 15;", "kMaxN1 = 9;", 1),
                                         ("int N1 = 2>", "int N1 = 9>", 2)]}
#: the f32 Coulomb free-space instantiation each variant reports
SYMBOL = {"batch_cluster_field": "field_kernelIfLi0ELb0ELb0E",
          "batch_cluster_field_grid": "grid_field_kernelIfLi9ELi0EE"}


def build_all(out_dir):
    """{(source, variant): (library path, nvcc log)}, all nvcc processes
    at once."""
    from repro_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for source, variants in VARIANTS.items():
        src = open(_build.CSRC / f"{source}.cu").read()
        for old, new, count in RESTRICT.get(source, []):
            assert src.count(old) == count, (source, old)
            src = src.replace(old, new)
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                assert text.count(old) == 1, (source, name, old)
                text = text.replace(old, new)
            cu = os.path.join(out_dir, f"{source}_{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            lib = os.path.join(out_dir, f"lib{source}_{name}.so")
            procs[source, name] = (subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS,
                 f"-I{_build.CSRC}", "-o", lib, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                lib)
    out = {}
    for key, (p, lib) in procs.items():
        log, _ = p.communicate()
        assert p.returncode == 0, log
        out[key] = (lib, log)
    return out


def main() -> int:
    import numpy as np
    import torch
    from chip_smoke import (event_ms, field_rows_close, ptxas_usage,
                            sass_inner_loop, smi_line)
    from repro_torch.configs.bltc import fig4
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--rows", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("field_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_all(os.path.join(ROOT, "build", "field_variants"))
    dev = torch.device("cuda", 0)
    cfg = fig4(theta=0.7, degree=8)
    rng = np.random.default_rng(2020)
    x = rng.uniform(-1, 1, (args.n, 3)).astype(np.float32)
    q = torch.as_tensor(rng.uniform(-1, 1, args.n).astype(np.float32),
                        device=dev)
    plan = TreecodeSolver(cfg).plan(x)
    a = plan.arrays
    lanes = ev.lane_inputs(a, q, degree=cfg.degree, backend="cuda",
                           grid_nodes=True)
    kern = plan.kernel
    tgt = a["tgt_batched"]
    print(f"# {smi_line()}; N={args.n}, Fig. 4 plan, batch rows "
          f"{tgt.shape[0]}", flush=True)
    plan_of = {"batch_cluster_field": ("direct", ops.batch_cluster_field,
                                       bcm.FIELD_SIGNATURES,
                                       bcm.batch_cluster_field_plain),
               "batch_cluster_field_grid": (
                   "approx", ops.batch_cluster_field_grid,
                   bcm.GRID_FIELD_SIGNATURES,
                   bcm.batch_cluster_field_grid_plain)}
    for source, variants in VARIANTS.items():
        lane, op, sigs, plain = plan_of[source]
        idx, src, qq, cnt = lanes[lane]
        loaded = {}
        for name in variants:
            path, log = libs[source, name]
            lib = ctypes.CDLL(path)
            for fn, argtypes in sigs.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            loaded[name] = lib
            use = [v for k, v in ptxas_usage(log).items()
                   if SYMBOL[source] in k]
            loop = sass_inner_loop(path, SYMBOL[source])
            sass = (f"{loop[0] / loop[1]:.2f} SASS a pair ({loop[0]} for "
                    f"{loop[1]})" if loop else "SASS not measured")
            print(f"{source} {name}: (registers, spill stores, spill loads)"
                  f" {use[0] if use else 'not found'}; {sass}", flush=True)

        def run(name, rows=None):
            # the committed wrapper, pointed at this variant's library
            _build._LIBS[source] = loaded[name]
            kw = dict(cnt)
            sub = (idx, tgt, src, qq)
            if rows is not None:
                kw["tgt_count"] = cnt["tgt_count"][:rows]
                sub = (idx[:rows], tgt[:rows], src, qq)
            return op(*sub, kernel=kern, backend="cuda", **kw)

        rows = args.rows
        real = a["tgt_mask"][:rows]
        sub_cnt = dict(cnt, tgt_count=cnt["tgt_count"][:rows])
        sub = (idx[:rows], tgt[:rows], src, qq)
        want = plain(*sub, kernel=kern, **sub_cnt)
        mag = plain(*sub, kernel=kern, magnitude=True, **sub_cnt)
        times = {name: [] for name in variants}
        for order in (list(variants), list(reversed(list(variants)))):
            for name in order:
                run(name)
                times[name].append(event_ms(lambda: run(name), 5))
        for name in variants:
            _, ratio, _ = field_rows_close(run(name, rows), want, mag, real,
                                           f"{source} {name}")
            print(f"{source} {name} ({lane} lane): "
                  f"{' / '.join(f'{t:.3f}' for t in times[name])} ms "
                  f"(median of 5, forward / reversed order); gradient max "
                  f"err / sum|terms| on {rows} rows {ratio:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

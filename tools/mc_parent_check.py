#!/usr/bin/env python3
"""The modified-charge kernels against an earlier commit's, on one GPU.

    python3 tools/mc_parent_check.py --parent DIR [--runtime]

DIR is a checkout of the earlier commit (e.g. unpacked with `git archive`
under the git-ignored `build/`). Its `csrc/modified_charges.cu` is built
with the port's flags into `build/mc_parent/` and loaded beside this
tree's; the wrapper `ops.modified_charges_ranged` calls whichever is
installed, so both run on the same inputs in one process.

- The paper's Fig. 4 plan (theta 0.7, degree 8, N_L = N_B = 2000, f32) at
  10^6 points uniform in [-1,1]^3 (phase 4's seed): q_hat of every node
  by both kernels, compared bitwise, and each timed in turns (earlier,
  this, this, earlier; CUDA events, median of 20 calls, two launches a
  call).
- The same setting on a sheet of 2*10^5 points at z = 0 (phase 4s's
  seed), every node flat in z: the earlier kernel's q_hat against this
  one's times (n+1)^k on a node flat in k dimensions (its denominator of
  1 for the n+1 hits of a flat dimension), and the relative 2-norm error
  of `execute`'s potential on 1000 sampled targets against an f64 direct
  sum with each kernel installed.

With --runtime, the runtime-degree kernels instead, on phase 21b's plan
(the Fig. 4 points at 10^6, f64, degree 16, n+1 = 17): the forward on the
plan's chunk table and the transpose on its tile table with 21b's seeded
q_hat cotangent, by both libraries; the two forwards held to each other
at rtol 1e-10 and atol 1e-12 max|q_hat|, the two transposes per entry
within MCT_K (1e-13) times the sum of the terms' magnitudes; each timed
in turns (earlier, this, this, earlier; CUDA events, median of 10); and
the f32 forward and transpose forced at n+1 = 9 (the runtime kernels
where the templates run) on a Fig. 4 plan in f32, held to each other at
phase 4's rule (the transposes: bitwise equal or not) and timed the
same way.

Prints the card's name and power limit first; needs a CUDA device.
"""
import argparse
import ctypes
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def parent_library(parent: str):
    """The earlier commit's modified-charge library, built with this
    tree's flags into build/mc_parent/."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import modified_charges as mcm

    csrc, env = _build.CSRC, os.environ.get("REPRO_TORCH_BUILD_DIR")
    _build.CSRC = Path(parent) / "src" / "repro_torch" / "kernels" / "csrc"
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build",
                                                       "mc_parent")
    try:
        path = _build.build(["modified_charges"])["modified_charges"]
    finally:
        _build.CSRC = csrc
        if env is None:
            os.environ.pop("REPRO_TORCH_BUILD_DIR")
        else:
            os.environ["REPRO_TORCH_BUILD_DIR"] = env
    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "mc_runtime"):
        for fn, argtypes in mcm._SIGNATURES.items():
            f = getattr(lib, fn, None)      # entries added since: absent
            if f is not None:
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
        return lib
    return Templates(lib, mcm._SIGNATURES)


class Templates:
    """A library from before the runtime-degree kernels, in this tree's
    calling convention: its forward and transposed entries lack the
    force_runtime argument (dropped here), and it has templates only."""

    def __init__(self, lib, signatures):
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn, None)
            if f is None:
                continue
            if fn.startswith(("mc_eval", "mct_eval")):
                f.argtypes = list(argtypes[:-2] + argtypes[-1:])
                f.restype = ctypes.c_int
                setattr(self, fn, self._without_flag(f))
            else:
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
                setattr(self, fn, f)

    @staticmethod
    def _without_flag(f):
        def call(*args):
            assert args[-2] == 0, "the earlier library cannot force it"
            return f(*args[:-2], args[-1])
        return call

    @staticmethod
    def mc_runtime(n1):
        return 0


def runtime_check(libs) -> None:
    """The runtime-degree forward and transpose of both libraries on 21b's
    plan, held to each other and timed in turns."""
    import dataclasses

    import numpy as np
    import torch
    import chip_smoke as c
    from repro_torch.core import cheby
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.kernels import _build
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    degree, n1 = c.HIGH_DEGREE, c.HIGH_DEGREE + 1
    cfg = dataclasses.replace(c.fig4_config(), degree=degree,
                              dtype="float64")
    rng = np.random.default_rng(2020)               # 21b's points
    x = rng.uniform(-1, 1, (c.MAIN_N, 3))
    q = torch.as_tensor(rng.uniform(-1, 1, c.MAIN_N), device=dev)
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

    def fwd(which):
        _build._LIBS["modified_charges"] = libs[which]
        return ops.modified_charges_ranged(*mc_args, degree=degree,
                                           backend="cuda")

    def tr(which):
        _build._LIBS["modified_charges"] = libs[which]
        return ops.modified_charges_transpose_ranged(
            *mct_args, degree=degree, backend="cuda")

    # the f32 kernels forced at n+1 = 9 on a Fig. 4 plan (the FFMA forward,
    # the FFMA transpose), where the templates run unforced
    cfg9 = c.fig4_config()
    x9 = rng.uniform(-1, 1, (c.MAIN_N, 3)).astype(np.float32)
    q9 = torch.as_tensor(rng.uniform(-1, 1, c.MAIN_N).astype(np.float32),
                         device=dev)
    a9 = TreecodeSolver(cfg9).plan(x9).arrays
    inp9 = ev.kernel_inputs(a9, q9, degree=cfg9.degree)
    f9_args = (a9["src_sorted"], inp9.q_sorted, a9["mc_chunks"].int(),
               a9["mc_chunk_ptr"].int(),
               ops._cluster_nodes(a9["node_lo"], a9["node_hi"],
                                  cfg9.degree).contiguous(),
               cheby.bary_weights_1d(cfg9.degree, torch.float32, dev),
               cfg9.degree)
    t9, c9 = mcm.tile_table(a9["mc_chunks"], a9["parent_of"],
                            len(a9["bucket_nodes"]),
                            a9["src_sorted"].shape[0])
    t9_args = (a9["src_sorted"].contiguous(), torch.as_tensor(
        np.random.default_rng(2121).uniform(
            -1, 1, (a9["node_lo"].shape[0], (cfg9.degree + 1) ** 3)),
        dtype=torch.float32, device=dev), t9, c9,
        a9["node_lo"].contiguous(), a9["node_hi"].contiguous(), cfg9.degree)

    def fwd9(which):
        _build._LIBS["modified_charges"] = libs[which]
        return mcm.modified_charges_ranged_cuda(*f9_args, _runtime=True)

    def tr9(which):
        _build._LIBS["modified_charges"] = libs[which]
        return mcm.modified_charges_transpose_ranged_cuda(*t9_args,
                                                          _runtime=True)

    f = {w: fwd(w) for w in libs}
    t = {w: tr(w) for w in libs}
    f_err = c.close(f["this"], f["earlier"], 1e-10, 1e-12,
                    "runtime forward against the earlier kernel",
                    scale="max")
    mag = mcm.modified_charges_transpose_ranged_plain(*mct_args, degree,
                                                      magnitude=True)
    t_err, t_ratio = c.mct_rows_close(
        t["this"], t["earlier"], mag, c.MCT_K[8],
        "runtime transpose against the earlier kernel")
    f9_err = c.close(fwd9("this"), fwd9("earlier"), 3e-3, 3e-4,
                     "f32 forward forced at n+1 = 9", scale="max")
    t9_same = torch.equal(tr9("this"), tr9("earlier"))
    times = {w: ([], [], [], []) for w in libs}
    for w in ("earlier", "this", "this", "earlier"):
        times[w][0].append(c.event_ms(lambda: fwd(w), 10))
        times[w][1].append(c.event_ms(lambda: tr(w), 10))
        times[w][2].append(c.event_ms(lambda: fwd9(w), 10))
        times[w][3].append(c.event_ms(lambda: tr9(w), 10))
    _build._LIBS["modified_charges"] = libs["this"]
    print(f"runtime-degree kernels at n+1={n1}, f64, on 21b's plan "
          f"(N={c.MAIN_N}, {a['mc_chunks'].shape[0]} chunks, "
          f"{int((tiles[:, 0] < tiles[:, 1]).sum())} tiles): forward max "
          f"abs err against the earlier {f_err:.3e} (rtol 1e-10, atol 1e-12 "
          f"max|q_hat|), transpose {t_err:.3e} (max err / sum of magnitudes "
          f"{t_ratio:.3e}, MCT_K {c.MCT_K[8]}); ms a call (median of 10, in "
          f"turns earlier, this, this, earlier): forward earlier "
          f"{times['earlier'][0]}, this {times['this'][0]}; transpose "
          f"earlier {times['earlier'][1]}, this {times['this'][1]}; f32 "
          f"forced at n+1 = 9 on a Fig. 4 plan: forward earlier "
          f"{times['earlier'][2]}, this {times['this'][2]} (max abs err "
          f"between them {f9_err:.3e}, phase 4's rule), transpose earlier "
          f"{times['earlier'][3]}, this {times['this'][3]} (bitwise equal: "
          f"{t9_same})", flush=True)


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as c
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.core.direct import direct_sum
    from repro_torch.kernels import _build
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--runtime", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mc_parent_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(c.smi_line(), flush=True)
    libs = {"this": _build.load("modified_charges", mcm._SIGNATURES),
            "earlier": parent_library(args.parent)}
    if args.runtime:
        runtime_check(libs)
        return 0

    def qhat(which, mc_args, degree):
        _build._LIBS["modified_charges"] = libs[which]
        return ops.modified_charges_ranged(*mc_args, degree=degree,
                                           backend="cuda")

    cfg = c.fig4_config()
    rng = np.random.default_rng(2020)               # phase 4's points
    x = rng.uniform(-1, 1, (c.MAIN_N, 3)).astype(np.float32)
    q = torch.as_tensor(rng.uniform(-1, 1, c.MAIN_N).astype(np.float32),
                        device=dev)
    plan = TreecodeSolver(cfg).plan(x)
    a = plan.arrays
    inp = ev.kernel_inputs(a, q, degree=cfg.degree)
    mc_args = (a["src_sorted"], inp.q_sorted, a["mc_chunks"],
               a["mc_chunk_ptr"], a["node_lo"], a["node_hi"])
    got = {w: qhat(w, mc_args, cfg.degree) for w in libs}
    equal = torch.equal(got["this"], got["earlier"])
    times = {w: [] for w in libs}
    for w in ("earlier", "this", "this", "earlier"):
        times[w].append(c.event_ms(lambda: qhat(w, mc_args, cfg.degree), 20))
    print(f"Fig. 4 at N={c.MAIN_N} (3-D): q_hat of {got['this'].shape[0]} "
          f"nodes bitwise equal: {equal}; ms a call (median of 20, in turns "
          f"earlier, this, this, earlier): earlier {times['earlier']}, this "
          f"{times['this']}", flush=True)
    assert equal, "the kernel's output changed on rows with at most one hit"
    del plan, a, inp, mc_args, got

    n = c.SHEET_N
    rng = np.random.default_rng(2022)               # phase 4s's sheet
    x = np.zeros((n, 3), np.float32)
    x[:, :2] = rng.uniform(-1, 1, (n, 2))
    q = torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32), device=dev)
    sample = torch.as_tensor(rng.choice(n, 1000, replace=False), device=dev)
    solver = TreecodeSolver(cfg)
    plan = solver.plan(x)
    a = plan.arrays
    inp = ev.kernel_inputs(a, q, degree=cfg.degree)
    mc_args = (a["src_sorted"], inp.q_sorted, a["mc_chunks"],
               a["mc_chunk_ptr"], a["node_lo"], a["node_hi"])
    got = {w: qhat(w, mc_args, cfg.degree) for w in libs}
    flat = (a["node_lo"] == a["node_hi"]).sum(1)
    approx = a["approx_idx"]
    swept = torch.unique(approx[approx >= 0])
    factor = (cfg.degree + 1.0) ** flat.to(torch.float32)
    scaled = got["this"] * factor[:, None]
    dev_rel = ((got["earlier"] - scaled)[swept].abs().max()
               / scaled[swept].abs().max()).item()
    x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
    ref = direct_sum(x64[sample], x64, q.double(), kernel=solver.kernel,
                     source_chunk=1 << 15)
    errs = {}
    for w in libs:          # the whole execute, each kernel installed
        _build._LIBS["modified_charges"] = libs[w]
        errs[w] = c.rel2(plan.execute(q)[sample].double(), ref)
    _build._LIBS["modified_charges"] = libs["this"]
    print(f"sheet N={n} at z = 0: {swept.numel()} approximation-lane nodes, "
          f"flat in {int(flat[swept].min())}-{int(flat[swept].max())} "
          f"dimensions; the earlier kernel's q_hat against this one's x "
          f"(n+1)^flat: max abs deviation / max|q_hat| {dev_rel:.3e}; "
          f"execute's phi error against an f64 direct sum on 1000 sampled "
          f"targets with this kernel {errs['this']:.3e}, with the earlier "
          f"kernel {errs['earlier']:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

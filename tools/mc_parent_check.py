#!/usr/bin/env python3
"""The forward modified-charge kernel against an earlier commit's, on one GPU.

    python3 tools/mc_parent_check.py --parent DIR

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
            f = getattr(lib, fn)
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mc_parent_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(c.smi_line(), flush=True)
    libs = {"this": _build.load("modified_charges", mcm._SIGNATURES),
            "earlier": parent_library(args.parent)}

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

#!/usr/bin/env python3
"""Run some of `chip_smoke.py`'s phases alone on one GPU.

    python3 tools/chip_phases.py [8 8d 8a 10 11 ...]

Builds the kernels, makes the main phase's Fig. 4 points and charges
(10^6, the same seed) and runs the named phases of `chip_smoke.py`
(default: 10, 11, 8d and 8a: the device-built plan, the hierarchical
precompute and the 10^6 MD with device rebuilds, synchronous and
async), each with its own checks. Also: 4 and 4f (the Fig. 4 execute
and forces at 10^6), w (the four kernels' systems-axis cases of phases
2, 2f, 2g and 3) and 12a-12d (serving: the ensemble, the kappa scan,
the service and the ensemble MD), 13a and 13b (the sharded plan at
Fig. 4 beside the single plan, built here unless 4 ran first, and the
sharded MD), 14 (the differentiable executor's backward on the Fig. 4
plan, built here unless 4 ran first). A failing phase prints its traceback
and the rest still run; the exit code is 1 if any failed. Phase 11's
line compares the hierarchical q_hat with this run's direct one only
(phase 4 runs here only when named). Prints the
card's name and power limit first; needs a CUDA device.
"""
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as c
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = c.smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(2020)               # phase 4's points
    x = rng.uniform(-1, 1, (c.MAIN_N, 3)).astype(np.float32)
    q = torch.as_tensor(rng.uniform(-1, 1, c.MAIN_N).astype(np.float32),
                        device=dev)
    main = {}

    def phase_main():
        main["plan"], _, _, _ = c.phase_main(dev, smi)

    def phase_forces():
        if "plan" not in main:
            phase_main()
        c.phase_forces(dev, main["plan"], x, q, smi)

    def phase_differentiable():
        if "plan" not in main:      # phase 4's plan, without its checks
            from repro_torch.core.api import TreecodeSolver
            main["plan"] = TreecodeSolver(c.fig4_config()).plan(x)
        c.phase_differentiable(dev, smi, main["plan"], x, q)

    def systems_axis():
        for kind in ("batch_cluster", "field", "grid_field",
                     "modified_charges"):
            c.print_systems_axis(f"[{kind}]", kind, dev)

    phases = {
        "4": phase_main,
        "4f": phase_forces,
        "w": systems_axis,
        "12a": lambda: c.phase_serve_ensemble(dev, smi),
        "12b": lambda: c.phase_serve_kappa_scan(dev),
        "12c": lambda: c.phase_serve_frontend(dev),
        "12d": lambda: c.phase_serve_md(dev),
        "8": lambda: c.phase_md(dev),
        "8d": lambda: c.phase_md(dev, "[8d]", "device"),
        "8a": lambda: c.phase_md(dev, "[8a]", "device", async_replan=True),
        "10": lambda: c.phase_device_plan(dev, smi, x, q),
        "11": lambda: c.phase_hierarchical(dev, x, q, float("nan")),
        "13a": lambda: c.phase_sharded(dev, smi, x, q, main.get("plan")),
        "13b": lambda: c.phase_sharded_md(dev),
        "14": phase_differentiable,
    }
    fails = 0
    for name in sys.argv[1:] or ["10", "11", "8d", "8a"]:
        t1 = time.perf_counter()
        try:
            phases[name]()
            print(f"phase {name} ok in {time.perf_counter() - t1:.1f} s",
                  flush=True)
        except Exception:
            fails += 1
            traceback.print_exc()
            print(f"phase {name} FAILED", flush=True)
        torch.cuda.synchronize()
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

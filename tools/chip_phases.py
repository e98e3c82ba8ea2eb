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
plan, built here unless 4 ran first), 15 (the checking tools: the lint,
the sync guard, transfer counts, REPRO_DEBUG_NANS and the meta dry run;
it reuses the plan, the MD, the device plan and the frontend of 4, 8, 10
and 12c when they ran first, and builds them otherwise), 4s (the Fig. 4
setting on a sheet at z = 0, host and device builds and the
hierarchical precompute) and 16 (LM serving: 16a, the ten archs at SMOKE
on the card against the CPU, 16b, gemma-7b at FULL in bf16, and 16c,
granite-moe, mamba2, zamba2, whisper-small and llava-next at FULL in
bf16; also runnable alone as 16a, 16b and 16c; no
kernel runs there, but the build comes first all the same) and 17 (LM
training: 17a, the ten archs' train step at SMOKE on the card against
the CPU, 17b, the launcher's resume, 17c, internlm2-1.8b at FULL in
bf16, 17d, granite-moe and mamba2 at FULL; each also alone) and 18 (the
LM dry run: 18a, 17c's step dry run on one device against a real step
under the same cost analysis, 18b, gemma-7b and arctic-480b train_4k on
the fake 256- and 512-rank meshes in a subprocess; each also alone). A failing
phase
prints its traceback
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
        c.phase_differentiable(dev, smi, fig4_plan(), x, q)

    def fig4_plan():
        if "plan" not in main:      # phase 4's plan, without its checks
            from repro_torch.core.api import TreecodeSolver
            main["plan"] = TreecodeSolver(c.fig4_config()).plan(x)
        return main["plan"]

    def checking_tools():
        c.phase_checking_tools(dev, smi, fig4_plan(), x, q, main.get("md"),
                               main.get("dplan"), main.get("serve"))

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
        "12c": lambda: main.update(serve=c.phase_serve_frontend(dev)),
        "12d": lambda: c.phase_serve_md(dev),
        "8": lambda: main.update(md=c.phase_md(dev)[3]),
        "8d": lambda: c.phase_md(dev, "[8d]", "device"),
        "8a": lambda: c.phase_md(dev, "[8a]", "device", async_replan=True),
        "10": lambda: main.update(dplan=c.phase_device_plan(dev, smi, x, q)),
        "11": lambda: c.phase_hierarchical(dev, x, q, float("nan")),
        "13a": lambda: c.phase_sharded(dev, smi, x, q, main.get("plan")),
        "13b": lambda: c.phase_sharded_md(dev),
        "14": phase_differentiable,
        "15": checking_tools,
        "4s": lambda: c.phase_sheet(dev, smi),
        "16a": lambda: c.phase_lm_smoke(dev),
        "16b": lambda: c.phase_lm_full(dev, smi),
        "16c": lambda: c.phase_lm_full_archs(dev, smi),
        "16": lambda: (c.phase_lm_smoke(dev), c.phase_lm_full(dev, smi),
                       c.phase_lm_full_archs(dev, smi)),
        "17": lambda: c.phase_train(dev, smi),
        "17a": lambda: c.phase_train(dev, smi, ("17a",)),
        "17b": lambda: c.phase_train(dev, smi, ("17b",)),
        "17c": lambda: c.phase_train(dev, smi, ("17c",)),
        "17d": lambda: c.phase_train(dev, smi, ("17d",)),
        "18": lambda: c.phase_dryrun(dev, smi),
        "18a": lambda: c.phase_dryrun(dev, smi, ("18a",)),
        "18b": lambda: c.phase_dryrun(dev, smi, ("18b",)),
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

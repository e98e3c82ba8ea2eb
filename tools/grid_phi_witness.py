#!/usr/bin/env python3
"""The grid field kernel's phi in `test_degree_above_14_runs_on_the_card`,
held to an f64 witness, on one GPU.

    python3 tools/grid_phi_witness.py [--cases 15:float32,24:float32,...]

Runs `tests/test_torch_cuda.py::test_degree_above_14_runs_on_the_card`
itself for each (degree, dtype), recording the inputs and output of each
of its grid field kernel calls, and reports whether the test passed. For
each call (free Coulomb; periodic Yukawa with Kahan sums) it then
computes the plain version in the test's dtype and in f64 on the same
inputs (cast up exactly) and prints, over the real targets: the largest
|kernel - plain| (what the test holds to rtol and atol 2e-4 in f32),
|kernel - f64| and |plain - f64|, each also over its entry's sum of the
terms' magnitudes sum |G q| (the rule `chip_smoke.py` phase 21c holds
this phi to, PHI_K per entry), and whether the kernel's and the plain
version's phi each lie within the test's rtol and atol of the f64 one.
Prints the card's name and power limit.
"""
import argparse
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    from chip_smoke import PHI_K, smi_line
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops
    import test_torch_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="15:float32,24:float32,15:float64,"
                    "24:float64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grid_phi_witness: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"# {smi_line()}", flush=True)
    kernel_call = ops.batch_cluster_field_grid
    for case in args.cases.split(","):
        degree, dtype = case.split(":")
        degree, dtype = int(degree), getattr(torch, dtype)
        calls = []

        def recorded(*gargs, backend="auto", **kw):
            out = kernel_call(*gargs, backend=backend, **kw)
            if backend != "torch":
                calls.append((gargs, kw, out))
            return out

        ops.batch_cluster_field_grid = recorded
        try:
            test_torch_cuda.test_degree_above_14_runs_on_the_card(
                dev, dtype, degree)
            verdict = "passed"
        except AssertionError:
            verdict = "FAILED: " + traceback.format_exc(limit=-1).strip()
        finally:
            ops.batch_cluster_field_grid = kernel_call
        print(f"degree {degree} {dtype}: the test {verdict}", flush=True)
        for (gargs, kw, got), name in zip(calls, ("free Coulomb",
                                                  "periodic Yukawa Kahan")):
            idx, tgt, nodes, qh = gargs
            want = ops.batch_cluster_field_grid(*gargs, backend="torch", **kw)
            up = (idx, tgt.double(), nodes.double(), qh.double())
            exact = ops.batch_cluster_field_grid(*up, backend="torch", **kw)
            mag = bcm.batch_cluster_field_grid_plain(*up, magnitude=True,
                                                     **kw)[..., 0]
            real = (torch.arange(tgt.shape[-2], device=dev)
                    < kw["tgt_count"][..., None])
            k, p, e = (v[..., 0][real].double() for v in (got, want, exact))
            m = mag[real].clamp(min=1e-300)
            tol = 2e-4 + 2e-4 * e.abs()

            def worst(d):
                return (f"{d.max().item():.4e} (/sum|G q| "
                        f"{(d / m).max().item():.4e})")
            print(f"  {name}: {k.numel()} entries, max|phi| "
                  f"{e.abs().max().item():.4e}, max sum|G q| "
                  f"{m.max().item():.4e}; |kernel - plain| "
                  f"{worst((k - p).abs())}; |kernel - f64| "
                  f"{worst((k - e).abs())}; |plain - f64| "
                  f"{worst((p - e).abs())}; within rtol, atol 2e-4 of f64: "
                  f"kernel {int(((k - e).abs() > tol).sum())} outside, "
                  f"plain {int(((p - e).abs() > tol).sum())} outside; "
                  f"PHI_K {PHI_K[dtype.itemsize]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

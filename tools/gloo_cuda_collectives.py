#!/usr/bin/env python3
"""Which collectives a gloo group runs on CUDA tensors, one card shared.

    python3 tools/gloo_cuda_collectives.py [--device cuda]

For each collective that DTensor issues (all_reduce, broadcast,
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single) and
each dtype (float32, bfloat16), starts 2 gloo processes on `--device`
(both on cuda:0 with one card) that run it once on a 4096-element
tensor and check the result; then an all-gather three more ways, in
float32: through the functional collectives DTensor calls
(`_functional_collectives.all_gather_tensor`, waited on), and each of
the two inside an autograd backward (which autograd runs on its own
thread for a CUDA device). Prints one line per case with its exit code
(-11: the process died of SIGSEGV) and the last line of any error.
Each case runs in processes of its own, so a crash ends only that case.
Needs no card with `--device cpu`.
"""
import argparse
import os
import subprocess
import sys
import tempfile

CASE = r"""
import sys
import torch
import torch.distributed as dist

store, rank, op, dtype, device = sys.argv[1:6]
rank = int(rank)
dist.init_process_group("gloo", init_method=f"file://{store}",
                        world_size=2, rank=rank)
dev = torch.device(device)
if dev.type == "cuda":
    torch.cuda.set_device(0)
dt = getattr(torch, dtype)
n = 4096
x = torch.full((n,), float(rank + 1), dtype=dt, device=dev)
if op == "all_reduce":
    dist.all_reduce(x)
    ok = bool((x == 3).all())
elif op == "broadcast":
    dist.broadcast(x, src=0)
    ok = bool((x == 1).all())
elif op == "all_gather_into_tensor":
    out = torch.empty(2 * n, dtype=dt, device=dev)
    dist.all_gather_into_tensor(out, x)
    ok = bool((out[:n] == 1).all() and (out[n:] == 2).all())
elif op == "reduce_scatter_tensor":
    out = torch.empty(n // 2, dtype=dt, device=dev)
    dist.reduce_scatter_tensor(out, x)
    ok = bool((out == 3).all())
elif op == "all_to_all_single":
    out = torch.empty(n, dtype=dt, device=dev)
    dist.all_to_all_single(out, x)
    ok = bool((out[:n // 2] == 1).all() and (out[n // 2:] == 2).all())
else:
    import torch.distributed._functional_collectives as funcol

    def gather(t):
        if op.startswith("functional"):
            return funcol.all_gather_tensor(t, 0, dist.group.WORLD).wait()
        out = torch.empty(2 * n, dtype=dt, device=dev)
        dist.all_gather_into_tensor(out, t)
        return out

    if op.endswith("in_backward"):
        class Gathered(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return t.clone()

            @staticmethod
            def backward(ctx, g):
                got = gather(g.contiguous())
                return got[:n] + got[n:]

        x.requires_grad_(True)
        Gathered.apply(x).sum().backward()
        ok = bool((x.grad == 2).all())
    else:
        out = gather(x)
        ok = bool((out[:n] == 1).all() and (out[n:] == 2).all())
dist.destroy_process_group()
sys.exit(0 if ok else 3)
"""

OPS = ("all_reduce", "broadcast", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single")
GATHERS = ("functional_all_gather_tensor",
           "all_gather_into_tensor_in_backward",
           "functional_all_gather_tensor_in_backward")


def run_case(script, store, op, dtype, device):
    """Exit codes of the case's 2 processes and the last line of any
    error."""
    procs = [subprocess.Popen([sys.executable, script, store, str(r), op,
                               dtype, device], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    codes, last = [], ""
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        codes.append(p.returncode)
        lines = [line for line in out.splitlines() if line.strip()]
        if p.returncode and lines:
            last = lines[-1]
    return codes, last


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cases = [(op, dt) for op in OPS for dt in ("float32", "bfloat16")]
    cases += [(op, "float32") for op in GATHERS]
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "case.py")
        with open(script, "w") as f:
            f.write(CASE)
        for op, dtype in cases:
            codes, last = run_case(script, os.path.join(tmp, f"{op}_{dtype}"),
                                   op, dtype, args.device)
            print(f"{op} {dtype} on {args.device}: exit codes {codes}"
                  f"{'; ' + last if last else ''}", flush=True)


if __name__ == "__main__":
    main()

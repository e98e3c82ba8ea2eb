"""Quickstart on the PyTorch port: the unified plan/execute/forces API on
20k Coulomb particles, on the card (`examples/quickstart.py`'s twin).

One solver facade covers every execution strategy:

  plan = solver.plan(points)             # SingleDevicePlan or ShardedPlan
  phi  = plan.execute(charges)           # potentials, input order
  phi, F = plan.potential_and_forces(q)  # + forces F_i = -q_i grad phi_i
  plan = plan.replan(new_points)         # moving particles (MD)

Under torchrun with P ranks `solver.plan` shards the points over the
process group (RCB + locally essential trees, one rank a process), as
the reference does on P devices; rank 0 prints:

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/quickstart_torch.py --device cpu

`--device cpu` runs the plain PyTorch path; `--n` sets the number of
particles (the reference's 20000 by default).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.direct import direct_sum


def group_mesh(device):
    """A 1-D mesh over the process group's ranks, on `device`'s type;
    None in one process."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type,
                            (dist.get_world_size(),))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(n=20_000, device="cuda", dtype=np.float32, mesh=None):
    """The quickstart's computation: a dict of the plan's stats, phi, the
    direct sum's phi, the relative 2-norm error, the forces and the
    times (s) of each part."""
    rng = np.random.default_rng(0)
    # random particles in the [-1,1]^3 cube, charges uniform on [-1,1]
    # (the paper's Sec. 4 test setting)
    points = rng.uniform(-1, 1, (n, 3)).astype(dtype)
    charges = rng.uniform(-1, 1, n).astype(dtype)

    solver = TreecodeSolver(TreecodeConfig(
        theta=0.8, degree=8, leaf_size=512, kernel="coulomb"), device=device)
    dev = solver.device
    q = torch.as_tensor(charges, device=dev)

    t0 = time.time()
    plan = solver.plan(points, mesh=mesh)  # sources default to the targets
    phi = plan.execute(q)
    _sync(dev)
    t_tree = time.time() - t0
    stats = plan.stats()

    x = torch.as_tensor(points, device=dev)
    t0 = time.time()
    phi_ds = direct_sum(x, x, q, kernel=solver.kernel)
    _sync(dev)
    t_direct = time.time() - t0
    err = float(torch.linalg.norm(phi - phi_ds) / torch.linalg.norm(phi_ds))

    # plan reuse with new charges (boundary-element / iterative-solver use)
    q2 = torch.as_tensor(rng.uniform(-1, 1, n).astype(dtype), device=dev)
    t0 = time.time()
    plan.execute(q2)
    _sync(dev)
    t_again = time.time() - t0

    # forces through the same plan (differentiable entry point)
    t0 = time.time()
    _, forces = plan.potential_and_forces(q)
    _sync(dev)
    t_forces = time.time() - t0
    return dict(n=n, stats=stats, phi=phi, phi_direct=phi_ds, err=err,
                forces=forces, t_tree=t_tree, t_direct=t_direct,
                t_again=t_again, t_forces=t_forces)


def main(argv=None):
    import torch.distributed as dist
    from repro_torch.launch.mesh import start_group

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the process group's backend under torchrun")
    args = ap.parse_args(argv)
    had_group = dist.is_initialized()
    dev = start_group(args.device, args.dist_backend)
    try:
        r = run(args.n, dev, mesh=group_mesh(dev))
        rank = dist.get_rank() if dist.is_initialized() else 0
    finally:
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()
    if rank:
        return r
    stats = r["stats"]
    print(f"N = {r['n']}   strategy = {stats['strategy']} "
          f"(nranks = {stats['nranks']})")
    print(f"treecode: {r['t_tree']:.2f}s (incl. tree build)   "
          f"direct sum: {r['t_direct']:.2f}s")
    print(f"relative 2-norm error (paper Eq. 16): {r['err']:.2e}")
    print(f"interaction-list padding waste: {stats['padding_waste']:.1%}")
    print(f"re-execute with new charges: {r['t_again']:.2f}s")
    print(f"potential + forces: {r['t_forces']:.2f}s  "
          f"|F| max = {float(r['forces'].abs().max()):.3g}")
    return r


if __name__ == "__main__":
    main()

"""An end-to-end run on the PyTorch port (`examples/md_nbody.py`'s twin):
N-body dynamics on the device-resident MD engine, on the card.

The `repro_torch.dynamics.Simulation` engine:

  - runs the integrator's half-kicks, the device tree refit and the
    treecode force evaluation (the hand-written field kernels) on the
    device: forces never visit the host between half-kicks, and a refit
    step reads one value to the host (the drift);
  - rebuilds the host tree only every `--refit-interval` steps (or
    earlier if particle drift exhausts the MAC slack budget), and each
    rebuild is re-padded into fixed buffer capacities, so the step's
    functions see the shapes they have seen (0 retraces);
  - `--rebuild always` rebuilds at every step, for comparison.

Pass ``--box L`` for periodic boundary conditions (minimum-image
convention in the cell [0, L)^3: the tree builds on wrapped coordinates,
kernels fold displacements, and the engine re-wraps positions at every
rebuild) — combine with ``--kernel yukawa --kappa 0.8`` for the classic
screened molten-salt setting.

    PYTHONPATH=src python examples/md_nbody_torch.py [--n 1500]
        [--steps 200] [--integrator velocity_verlet|leapfrog|langevin]
        [--refit-interval 25] [--rebuild auto|always|never]
        [--box 0] [--kernel coulomb] [--kappa 0.5]
        [--checkpoint DIR] [--device cpu]

`--device cpu` runs the plain PyTorch path. `--checkpoint DIR` writes
the trajectory through `repro_torch.checkpoint.store.Checkpointer`, in
the reference's layout.
"""
import argparse
import time

import numpy as np

from repro_torch.checkpoint.store import Checkpointer
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.space import FreeSpace, PeriodicBox
from repro_torch.dynamics import Simulation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1500)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dt", type=float, default=2e-4)
    ap.add_argument("--theta", type=float, default=0.8)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--leaf-size", type=int, default=64)
    ap.add_argument("--skin", type=float, default=0.0,
                    help="Verlet-skin radius: floors the refit drift "
                         "budget at skin/2 (drift-budget v2)")
    ap.add_argument("--integrator", default="velocity_verlet")
    ap.add_argument("--temperature", type=float, default=0.05,
                    help="langevin target temperature")
    ap.add_argument("--friction", type=float, default=1.0,
                    help="langevin friction")
    ap.add_argument("--refit-interval", type=int, default=25)
    ap.add_argument("--rebuild", default="auto",
                    choices=("auto", "always", "never"))
    ap.add_argument("--box", type=float, default=0.0,
                    help="periodic box edge L (0 = free space); particles "
                         "start uniform in [0, L)^3")
    ap.add_argument("--kernel", default="coulomb",
                    choices=("coulomb", "yukawa"))
    ap.add_argument("--kappa", type=float, default=0.5,
                    help="yukawa inverse screening length")
    ap.add_argument("--checkpoint", default=None,
                    help="directory for trajectory checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    if args.box > 0:
        space = PeriodicBox((args.box,) * 3)
        x = rng.uniform(0, args.box, (args.n, 3)).astype(np.float32)
    else:
        space = FreeSpace()
        x = rng.uniform(-1, 1, (args.n, 3)).astype(np.float32)
    q = (rng.uniform(-1, 1, args.n) * 0.05).astype(np.float32)

    kparams = {"kappa": args.kappa} if args.kernel == "yukawa" else {}
    solver = TreecodeSolver(TreecodeConfig(
        theta=args.theta, degree=args.degree, leaf_size=args.leaf_size,
        kernel=args.kernel, kernel_params=kparams, space=space,
        skin=args.skin), device=args.device)
    plan = solver.plan(x)

    params = {}
    if args.integrator == "langevin":
        params = dict(friction=args.friction, temperature=args.temperature)
    ckpt = Checkpointer(args.checkpoint) if args.checkpoint else None
    sim = Simulation(plan, q, dt=args.dt, integrator=args.integrator,
                     integrator_params=params,
                     refit_interval=args.refit_interval,
                     rebuild=args.rebuild,
                     checkpointer=ckpt,
                     checkpoint_every=args.checkpoint_every)

    record_every = max(1, args.steps // 10)
    t0 = time.time()

    def report(s):
        if s.steps % record_every:
            return
        d = s.log.last()
        print(f"step {s.steps:4d}  KE {d['kinetic']:10.6f}  "
              f"PE {d['potential']:10.6f}  E {d['energy']:10.6f}  "
              f"T {d['temperature']:8.5f}", flush=True)

    sim.run(args.steps, record_every=record_every, callback=report)
    elapsed = time.time() - t0

    s = sim.stats()
    print(f"\n{args.steps} MD steps in {elapsed:.1f}s "
          f"({elapsed / args.steps * 1e3:.0f} ms/step)")
    print(f"refits {s['refits']}  rebuilds {s['rebuilds']} "
          f"(drift {s['rebuilds_drift']}, interval {s['rebuilds_interval']})"
          f"  retraces {s['retraces']}")
    print(f"energy drift {sim.log.drift():.2e}  "
          f"momentum drift {sim.log.momentum_drift():.2e}")
    if ckpt is not None:
        ckpt.wait()
        print(f"checkpoints under {args.checkpoint}")
    return sim


if __name__ == "__main__":
    main()

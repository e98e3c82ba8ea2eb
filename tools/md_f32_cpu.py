#!/usr/bin/env python3
"""CPU checks behind the MD settings and the field kernel's fold rule.

    PYTHONPATH=src python tools/md_f32_cpu.py [--steps 20]

1. The energy balance |dKE + dPE| / dKE (`chip_smoke.energy_balance`)
   of short f32 velocity-Verlet runs on the plain PyTorch path, at the
   lattice spacings of `chip_smoke.py`'s MD phases but at 20^3
   particles: the free lattice (spacing 0.02) at coordinates 0.5-0.9,
   whose f32 ulp is that of most of the 10^6 lattice's, and the
   periodic salt box (spacing 2/58) at coordinates 1.0-1.69. For each
   (dt, skin) it prints dKE, dPE, the balance and the rebuilds by drift.
   A step that moves a typical particle less than half an ulp of its
   coordinate rounds the move away while the velocity keeps it.
2. Replays the random draws of `chip_smoke.py`'s phase 2f and counts, in
   each periodic case, the (target, source) pairs whose minimum-image
   fold rint(d * (1/L)) picks another image than round(d / L), the
   reference's (a quotient within an ulp of a half-integer).
3. f32 cancellation in forces on a neutral lattice: the relative 2-norm
   error of a plain f32 direct sum's forces (every pair, no
   approximation) against f64, on a 30^3 piece of the periodic salt
   lattice in its own periodic box, Coulomb and Yukawa (kappa 1).
"""
import argparse
import itertools
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core.api import TreecodeConfig, TreecodeSolver  # noqa: E402
from repro_torch.core.space import PeriodicBox  # noqa: E402
from repro_torch.dynamics import Simulation  # noqa: E402


def balance_runs(steps: int) -> None:
    m = 20
    x, q = cs.salt_lattice(m, 0.5, 0.02, 31)
    a = 2.0 / 58
    xp, qp = cs.salt_lattice(m, 1.0, a, 32)
    box = PeriodicBox((m * a,) * 3, origin=(1.0,) * 3)
    runs = [("free", x, q, dt, skin, {})
            for dt, skin in ((5e-7, 0.0), (5e-6, 0.01), (1e-5, 0.01))]
    runs += [("periodic", box.wrap(xp), qp, dt, 0.02,
              dict(space=box, kernel="yukawa", kernel_params={"kappa": 1.0}))
             for dt in (1e-5, 2e-5)]
    for name, pts, charges, dt, skin, kw in runs:
        cfg = TreecodeConfig(theta=0.7, degree=6, leaf_size=500, skin=skin,
                             **kw)
        plan = TreecodeSolver(cfg, device="cpu").plan(pts, capacities="auto")
        sim = Simulation(plan, charges, dt=dt, refit_interval=10)
        phi0, v0 = sim.state.phi.clone(), sim.state.v.clone()
        sim.run(steps)
        dke, dpe = cs.energy_balance(sim, phi0, v0)
        st = sim.stats()
        print(f"{name} dt {dt} skin {skin}: dKE {dke:.4e}, dPE {dpe:.4e}, "
              f"|dKE + dPE| / dKE {abs(dke + dpe) / max(dke, 1e-300):.3e}; "
              f"refits {st['refits']}, rebuilds {st['rebuilds']} (drift "
              f"{st['rebuilds_drift']})", flush=True)


def fold_replay() -> None:
    """phase_field's draws in its order (seed 13, count_case included)."""
    rng = np.random.default_rng(13)
    lengths = np.array((1.5, 2.0, 1.7))
    for dtype in (np.float32, np.float64):
        qlo = -1.0 if dtype == np.float32 else 0.0
        for (B, S, NB, C, m) in [(5, 9, 300, 11, 700), (3, 4, 40, 5, 24),
                                 (2, 3, 129, 3, 257), (1, 1, 8, 1, 8)]:
            for space, kern, kahan, counts in itertools.product(
                    ("free", "box"), ("coulomb", "yukawa(0.5)",
                                      "yukawa(1.7)"),
                    (False, True), (False, True)):
                tgt = rng.uniform(-1, 1, (B, NB, 3))
                src = rng.uniform(-1, 1, (C, m, 3))
                rng.uniform(qlo, 1, (C, m))
                idx = rng.integers(-1, C, (B, S))
                idx[:, S // 2] = -1
                if B > 1:
                    idx[0] = -1
                k = min(NB, m, 3)
                tgt[-1, :k] = src[0, :k]
                idx[-1, 0] = 0
                tc, sc = np.full(B, NB), np.full(C, m)
                if counts:
                    tc = rng.integers(0, NB + 1, B)
                    sc = rng.integers(0, m + 1, C)
                    tc[0], sc[-1] = 0, 0
                    if B > 1:
                        tc[1] = NB
                    if C > 1:
                        sc[0] = m
                if space == "free":
                    continue
                t, s = tgt.astype(dtype), src.astype(dtype)
                L = lengths.astype(dtype)
                inv = (dtype(1) / L).astype(dtype)
                n = 0
                for b, c in itertools.product(range(B), range(S)):
                    c = idx[b, c]
                    if c < 0:
                        continue
                    d = t[b, :tc[b], None, :] - s[c, None, :sc[c], :]
                    n += int((np.rint(d * inv) != np.rint(d / L)).sum())
                if n:
                    print(f"phase 2f {dtype.__name__} {(B, S, NB, C, m)} "
                          f"{kern} kahan={kahan} counts={counts}: {n} "
                          f"pair components fold to the other image",
                          flush=True)
    print("phase 2f replay done", flush=True)


def cancellation() -> None:
    from repro_torch.core.direct import direct_field
    from repro_torch.core.potentials import coulomb, yukawa
    m, a = 30, 2.0 / 58
    x, q = cs.salt_lattice(m, 0.0, a, 32)
    box = PeriodicBox((m * a,) * 3)
    x = box.wrap(x)
    for kern in (coulomb(), yukawa(1.0)):
        f = {}
        for dtype in (torch.float32, torch.float64):
            t = torch.as_tensor(x, dtype=dtype)
            qq = torch.as_tensor(q, dtype=dtype)
            _, g = direct_field(t, t, qq, kernel=kern, space=box,
                                source_chunk=1024)
            f[dtype] = (-qq[:, None] * g).double()
        err = cs.rel2(f[torch.float32], f[torch.float64])
        print(f"{kern.name} f32 direct-sum forces on {m}^3 vs f64: relative "
              f"2-norm {err:.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    torch.set_num_threads(4)
    fold_replay()
    cancellation()
    balance_runs(args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

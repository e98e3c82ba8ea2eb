#!/usr/bin/env python3
"""The error bar of `chip_smoke.py` phase 21b, derived on the CPU from the
JAX reference: the Fig. 4 setting (theta 0.7, Coulomb; N_L = N_B as given)
at degree 16 in f64 on N points uniform in [-1, 1]^3 with charges uniform
in [-1, 1], phi and forces against an f64 direct sum on 1000 sampled
targets (relative 2-norm), and the share of (target, source) pairs the
approximation lane takes.

    python3 tools/degree16_bar.py [N] [degree] [N_L]  # default 350000 16 712

Only a cluster of more than (n+1)^3 = 4913 particles is approximated at
degree 16, so the phase's tree at 10^6 points and N_L = 2000 (clusters of
15330-125579 particles at levels 1-2 approximated, leaves at level 3 of
~1953 particles, 14% of them over 2000 and split in eight) is too large
for the reference on a CPU. The defaults give the same tree shape with a third of the
points: level-2 nodes of ~5470 > 4913, level-3 leaves of ~684 with 14%
over 712 (37 minutes on 8 CPU cores, ~6 GiB). Relative errors at a
fixed tree shape do not grow with N: both the far field's error and phi
grow as sqrt(N) for charges of random sign.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from repro.core.api import TreecodeConfig, TreecodeSolver
    from repro.core.direct import direct_sum

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 350_000
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    leaf = int(sys.argv[3]) if len(sys.argv) > 3 else 712
    rng = np.random.default_rng(2020)
    x = rng.uniform(-1, 1, (n, 3))
    q = rng.uniform(-1, 1, n)
    cfg = TreecodeConfig(theta=0.7, degree=degree, leaf_size=leaf,
                         kernel="coulomb", backend="xla")
    t0 = time.perf_counter()
    plan = TreecodeSolver(cfg).plan(x, nranks=1)
    phi, force = plan.potential_and_forces(q)
    phi.block_until_ready()
    path_s = time.perf_counter() - t0
    sample = rng.choice(n, 1000, replace=False)
    xj, qj = jnp.asarray(x), jnp.asarray(q)
    ref = np.asarray(direct_sum(xj[sample], xj, qj, kernel=plan.kernel))

    def phi_at(t):
        return direct_sum(t[None], xj, qj, kernel=plan.kernel)[0]

    grad_at = jax.jit(jax.vmap(jax.grad(phi_at)))
    grad = np.concatenate([np.asarray(grad_at(xj[sample[i:i + 100]]))
                           for i in range(0, sample.size, 100)])
    fref = -q[sample, None] * grad

    def rel2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    a = plan.inner.arrays
    counts = np.asarray(plan.inner.tree.count)
    nt = np.asarray(a["tgt_mask"]).sum(1)
    approx = np.asarray(a["approx_idx"])
    pairs = float((nt[:, None] * np.where(approx >= 0, counts[
        np.maximum(approx, 0)], 0)).sum())
    used = np.unique(approx[approx >= 0])
    print(f"N={n} degree={degree} theta=0.7 N_L=N_B={leaf} f64: "
          f"{a['tgt_batched'].shape[0]} batches, {counts.size} nodes, "
          f"{used.size} clusters approximated holding "
          f"{counts[used].min() if used.size else 0}-"
          f"{counts[used].max() if used.size else 0} particles; plan and "
          f"potential_and_forces {path_s:.1f} s; phi rel 2-norm "
          f"error {rel2(np.asarray(phi)[sample], ref):.3e}, forces "
          f"{rel2(np.asarray(force)[sample], fref):.3e} against an f64 direct "
          f"sum on 1000 targets; the approximation lane takes "
          f"{pairs / float(n) ** 2:.3f} of the N^2 pairs "
          f"({int((approx >= 0).sum())} slots)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

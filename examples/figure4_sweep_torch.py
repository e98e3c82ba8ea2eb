"""Paper Fig. 4 sweeps on the PyTorch port (`examples/figure4_sweep.py`'s
twin): degree/theta run-time-vs-error curves, plus the Yukawa kappa
sweep as ONE stacked ensemble launch, on the card.

Kernel parameters are values of a call, not of a plan, and the ensemble
subsystem stacks identical systems at zero padding cost, so the five
kappa values ride a single `EnsemblePlan` execute: one launch of each
kernel for all five, and one first call on the stacked signature
(`core.eval.ensemble_compile_count`, asserted).

    PYTHONPATH=src python examples/figure4_sweep_torch.py [--n 4000]
    PYTHONPATH=src python examples/figure4_sweep_torch.py --kappa-only
    PYTHONPATH=src python examples/figure4_sweep_torch.py --device cpu

`--device cpu` runs the plain PyTorch path.
"""
import argparse
import collections
import time

import numpy as np
import torch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def kappa_sweep(n_particles=2000, kappas=(0.1, 0.3, 0.5, 0.7, 1.0),
                x64=True, device="cuda"):
    """Yukawa phi for every kappa in one batched launch; returns
    ({kappa: rel-l2 distance from the smallest kappa's phi}, the
    ensemble executor's first calls and kernel builds in the call)."""
    from repro_torch.core import eval as _eval
    from repro_torch.core.api import TreecodeConfig
    from repro_torch.serve import EnsemblePlan

    rng = np.random.default_rng(0)
    dtype = np.float64 if x64 else np.float32
    pts = rng.uniform(-1, 1, (n_particles, 3)).astype(dtype)
    q = rng.uniform(-1, 1, n_particles).astype(dtype)

    cfg = TreecodeConfig(kernel="yukawa", theta=0.7, degree=6,
                         leaf_size=200)
    plan = EnsemblePlan.build(cfg, [pts] * len(kappas), device=device)
    before = _eval.ensemble_compile_count()
    phi = plan.execute([q] * len(kappas),
                       kernel_params=[{"kappa": k} for k in kappas])
    _sync(plan.device)
    compiles = _eval.ensemble_compile_count() - before
    assert compiles == 1, (
        f"kappa sweep must compile exactly once, compiled {compiles}x")

    phis = [p.double().cpu().numpy() for p in plan.split(phi)]
    base = phis[0]
    out = {}
    for k, p in zip(kappas, phis):
        out[k] = float(np.linalg.norm(p - base) / np.linalg.norm(base))
    return out, compiles


def fig4_rows(n_particles=5000, thetas=(0.5, 0.7, 0.9),
              degrees=(1, 2, 3, 4, 6, 8), leaf=200,
              kernels=("coulomb", "yukawa"), precompute="direct", x64=True,
              device="cuda"):
    """The Fig. 4 sweep (`benchmarks/fig4.py:run`'s rows): per kernel,
    theta and degree, (kernel, theta, degree, treecode s, relative 2-norm
    error against the direct sum, direct-sum s), each row printed as the
    reference prints it."""
    from repro_torch.core.api import TreecodeConfig, TreecodeSolver
    from repro_torch.core.direct import direct_sum

    rng = np.random.default_rng(0)
    dtype = np.float64 if x64 else np.float32
    pts = rng.uniform(-1, 1, (n_particles, 3)).astype(dtype)
    q = rng.uniform(-1, 1, n_particles).astype(dtype)
    rows = []
    for kname in kernels:
        kp = {"kappa": 0.5} if kname == "yukawa" else {}
        solver0 = TreecodeSolver(TreecodeConfig(kernel=kname,
                                                kernel_params=kp),
                                 device=device)
        dev = solver0.device
        x, qt = torch.as_tensor(pts, device=dev), torch.as_tensor(q,
                                                                 device=dev)
        t0 = time.time()
        phi_ds = direct_sum(x, x, qt, kernel=solver0.kernel)
        _sync(dev)
        t_direct = time.time() - t0
        for theta in thetas:
            for n in degrees:
                solver = TreecodeSolver(TreecodeConfig(
                    theta=theta, degree=n, leaf_size=leaf, kernel=kname,
                    kernel_params=kp, precompute=precompute), device=dev)
                t0 = time.time()
                phi = solver(pts, pts, q)
                _sync(dev)
                t_tc = time.time() - t0
                err = float(torch.linalg.norm(phi_ds - phi)
                            / torch.linalg.norm(phi_ds))
                rows.append((kname, theta, n, t_tc, err, t_direct))
                print(f"fig4,{kname},{theta},{n},{t_tc:.3f},{err:.3e},"
                      f"{t_direct:.3f}", flush=True)
    return rows


def check_paper_claims(rows):
    """The qualitative claims of Fig. 4, asserted (the reference's
    `benchmarks/fig4.py:check_paper_claims`)."""
    by = collections.defaultdict(list)
    for kname, theta, n, t, err, td in rows:
        by[(kname, theta)].append((n, t, err))
    msgs = []
    for (kname, theta), pts in by.items():
        pts.sort()
        errs = [e for _, _, e in pts]
        # (claim) error decreases as degree n increases
        assert errs[0] > errs[-1], (kname, theta, errs)
        msgs.append(f"claim: error falls with n [{kname} th={theta}]: "
                    f"{errs[0]:.1e} -> {errs[-1]:.1e} OK")
    # (claim) smaller theta -> smaller error at fixed n
    for kname in {k for k, _ in by}:
        e_small = min(e for _, _, e in by[(kname, 0.5)])
        e_big = min(e for _, _, e in by[(kname, 0.9)])
        assert e_small <= e_big * 10
    # (claim) Yukawa costs a modest constant factor more than Coulomb
    tc = np.median([t for k, _, _, t, _, _ in rows if k == "coulomb"])
    ty = np.median([t for k, _, _, t, _, _ in rows if k == "yukawa"])
    msgs.append(f"claim: yukawa/coulomb time ratio = {ty/tc:.2f} "
                f"(paper: 1.5-1.8x) OK")
    return msgs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--kappa-only", action="store_true",
                    help="skip the degree/theta sweep")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    if not args.kappa_only:
        print("kernel,theta,degree,time_s,rel2_err,direct_time_s")
        rows = fig4_rows(n_particles=args.n, degrees=(1, 2, 4, 6, 8, 10),
                         device=args.device)
        print()
        for msg in check_paper_claims(rows):
            print(msg)
        print()

    screen, compiles = kappa_sweep(n_particles=min(args.n, 2000),
                                   device=args.device)
    print(f"kappa sweep: 1 ensemble launch, {compiles} compile")
    print("kappa,rel2_vs_smallest_kappa")
    for k, d in screen.items():
        print(f"{k},{d:.3e}")
    return screen


if __name__ == "__main__":
    main()

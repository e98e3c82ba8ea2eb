#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):

 1. device line (nvidia-smi name and power limit), torch version, and the
    build of every CUDA kernel from `src/repro_torch/kernels/csrc/`
    (one nvcc per source, started together);
 2. batch_cluster kernel vs its plain PyTorch version: interior -1
    slots, an all-empty row, a coincident target/source pair, ragged
    NB and m, free and periodic space, Coulomb and Yukawa at two kappas,
    Kahan and the matmul-r2 form; f32 rtol/atol 2e-4, f64 rtol 1e-12
    (f64 cases use positive charges, so no entry cancels towards 0);
 3. modified_charges kernel vs its plain version at degrees 1, 4, 8, 14
    with random points, exact hits on the nodes and center-filled
    padding; f32 rtol 3e-3 / atol 3e-4, f64 rtol 1e-10 / atol 1e-12
    times max|q_hat| (signed sums over up to 4096 particles);
 4. the main path: the paper's Fig. 4 setting (theta 0.7, degree 8,
    N_L = N_B = 2000, Coulomb, f32) at N = 10^6 uniform in [-1,1]^3
    with charges uniform in [-1,1]. Plan, one cold and 7 warm
    executes (CUDA events), the relative 2-norm error against an f64
    direct sum on 1000 sampled targets (<= 1e-5), both lanes' kernels
    and the modified charges against their plain versions on the
    tensors execute feeds them (there the atol is relative to
    max|q_hat| or median|phi|: the sums run over up to 10^6 terms), and
    the launch counters of the run (modified charges: one launch per
    tree level, plus the split reduction on levels that split);
 5. a Yukawa sweep (kappa 0.5, then 1.0) on the same geometry with
    the kappas as device tensors: no rebuild, and no host sync
    (torch.cuda.set_sync_debug_mode("error") around the calls);
 6. a periodic box with a Verlet skin at N = 2*10^5 against an f64
    minimum-image direct sum on sampled targets;
 7. one JSON line per kernel (launches, error against the plain
    version, times, bound), the device line, and the final status line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds.
PEAK_FP32 = 67e12      # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3 bytes/s
# Operations per (target, source) pair of the batch-cluster sum:
# 3 sub + 3 mul + 2 add (r^2), sqrt, divide, multiply by q, add.
FLOPS_PER_PAIR = 12


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int):
    """Median milliseconds of `fn()` over `reps` runs, CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def close(got, want, rtol, atol, what, scale=None):
    """Max abs error of `got` against `want`; asserts every entry is
    within atol + rtol*|want|. With `scale` ("max" or "median"), atol is
    relative to max|want| or median|want|: entries that cancel towards 0
    keep the absolute rounding of the sum's larger terms."""
    import torch
    assert torch.isfinite(got).all(), f"{what}: non-finite output"
    if scale == "max":
        atol = atol * want.abs().max().item()
    elif scale == "median":
        atol = atol * want.abs().median().item()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} entries outside rtol={rtol} atol={atol}"
        f" (max abs err {err.max().item():.3e}, max|want| "
        f"{want.abs().max().item():.4e}, median|want| "
        f"{want.abs().median().item():.4e})")
    return err.max().item()


def rel2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def phase_batch_cluster(dev):
    import numpy as np
    import torch
    from repro_torch.core.potentials import coulomb, yukawa
    from repro_torch.core.space import FREE, PeriodicBox
    from repro_torch.kernels import ops

    rng = np.random.default_rng(11)
    kernels = (coulomb(), yukawa(0.5), yukawa(1.7))
    box = PeriodicBox((1.5, 2.0, 1.7), origin=(-0.75, -1.0, -0.85))
    n = 0
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-12, 0.0)
        qlo = -1.0 if dtype == torch.float32 else 0.0
        for (B, S, NB, C, m) in [(5, 9, 300, 11, 700), (3, 4, 40, 5, 24),
                                 (2, 3, 129, 3, 257), (1, 1, 8, 1, 8)]:
            for space in (FREE, box):
                for kern in kernels:
                    for kahan in (False, True):
                        for r2 in (("diff", "matmul") if not space.periodic
                                   else ("diff",)):
                            tgt = rng.uniform(-1, 1, (B, NB, 3))
                            src = rng.uniform(-1, 1, (C, m, 3))
                            if r2 == "matmul":   # MAC-separated geometry
                                src = src + np.array([4.0, 0.0, 0.0])
                            q = rng.uniform(qlo, 1, (C, m))
                            idx = rng.integers(-1, C, (B, S))
                            idx[:, S // 2] = -1          # interior sentinel
                            if B > 1:
                                idx[0] = -1              # all-empty row
                            if r2 == "diff":             # coincident pair
                                tgt[-1, 0] = src[0, 0]
                                idx[-1, 0] = 0
                            t = [torch.as_tensor(a, dtype=dtype, device=dev)
                                 for a in (tgt, src, q)]
                            it = torch.as_tensor(idx, dtype=torch.int32,
                                                 device=dev)
                            kw = dict(kernel=kern, space=space, kahan=kahan,
                                      r2_mode=r2)
                            got = ops.batch_cluster_eval(
                                it, *t, backend="cuda", **kw)
                            want = ops.batch_cluster_eval(
                                it, *t, backend="torch", **kw)
                            what = (f"batch_cluster {dtype} {(B, S, NB, C, m)}"
                                    f" {space} {kern.name}{kern.params} "
                                    f"kahan={kahan} r2={r2}")
                            err = close(got, want, rtol, atol, what)
                            worst[dtype] = max(worst[dtype], err)
                            if B > 1:
                                assert (got[0] == 0).all(), what
                            n += 1
    torch.cuda.synchronize()
    print(f"[2] batch_cluster vs plain: {n} cases ok; max abs err "
          f"f32 {worst[torch.float32]:.3e} (rtol/atol 2e-4), f64 "
          f"{worst[torch.float64]:.3e} (rtol 1e-12)", flush=True)


def phase_modified_charges(dev):
    import numpy as np
    import torch
    from repro_torch.core import cheby
    from repro_torch.kernels import ops

    rng = np.random.default_rng(12)
    n = 0
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        rtol, atol = (3e-3, 3e-4) if dtype == torch.float32 else (1e-10, 1e-12)
        for degree in (1, 4, 8, 14):
            for (C, m) in [(7, 512), (1, 4096), (3, 100), (300, 64)]:
                lo = rng.uniform(-1, 0, (C, 3))
                hi = lo + rng.uniform(0.3, 1, (C, 3))
                lo_t = torch.as_tensor(lo, dtype=dtype, device=dev)
                hi_t = torch.as_tensor(hi, dtype=dtype, device=dev)
                pts = lo_t[:, None] + (hi_t - lo_t)[:, None] * torch.as_tensor(
                    rng.uniform(0, 1, (C, m, 3)), dtype=dtype, device=dev)
                grid = cheby.cluster_grid(lo_t, hi_t, degree)
                k = min(m // 3, grid.shape[1])
                pts[:, :k] = grid[:, :k]                  # exact hits
                q = torch.as_tensor(rng.uniform(-1, 1, (C, m)), dtype=dtype,
                                    device=dev)
                pad = max(1, m // 8)                      # center padding
                pts[:, -pad:] = (0.5 * (lo_t + hi_t))[:, None]
                q[:, -pad:] = 0
                got = ops.modified_charges(pts, q, lo_t, hi_t, degree=degree,
                                           backend="cuda")
                want = ops.modified_charges(pts, q, lo_t, hi_t,
                                            degree=degree, backend="torch")
                worst[dtype] = max(worst[dtype], close(
                    got, want, rtol, atol,
                    f"modified_charges {dtype} degree={degree} C={C} m={m}",
                    scale="max" if dtype == torch.float64 else None))
                n += 1
    torch.cuda.synchronize()
    print(f"[3] modified_charges vs plain: {n} cases ok; max abs err f32 "
          f"{worst[torch.float32]:.3e} (rtol 3e-3 atol 3e-4), f64 "
          f"{worst[torch.float64]:.3e} (rtol 1e-10, atol 1e-12 max|q_hat|)",
          flush=True)


def bc_bound(plan, idx, m_of_cluster, dtype_bytes, src_elems):
    """(bound_ms, side, pairs) of one batch-cluster launch: the pairs the
    data needs (real targets x real sources of every valid slot)."""
    import torch
    a = plan.arrays
    nt = a["tgt_mask"].sum(1).to(torch.float64)           # (B,)
    valid = idx >= 0
    mc = m_of_cluster[idx.clamp(min=0).long()].to(torch.float64)
    pairs = float((nt[:, None] * mc * valid).sum())
    b, nb = a["tgt_batched"].shape[:2]
    nbytes = (idx.numel() * 4 + b * nb * 3 * dtype_bytes
              + src_elems * 4 * dtype_bytes + b * nb * dtype_bytes)
    t_ops = pairs * FLOPS_PER_PAIR / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    side = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, side, pairs


def mc_bound(plan, degree, dtype_bytes):
    """(bound_ms, side) of one execute's modified charges: per real
    particle of every cluster 3 rows of n+1 terms (sub, div, add), the
    denominator and q~ (2 mul, 1 div), t3*q~ (n+1 mul), t1 x t2 once
    ((n+1)^2 mul), then one FMA (2 operations) per (n+1)^3 output; bytes:
    xyz + q per real particle, the nodes and q_hat."""
    tree = plan.inner.tree
    n1 = degree + 1
    particles = float(tree.count.sum())                    # over all nodes
    flops = particles * (9 * n1 + 3 + n1 + n1 ** 2 + 2 * n1 ** 3)
    nbytes = (particles * 4 * dtype_bytes
              + tree.num_nodes * (3 * n1 + n1 ** 3) * dtype_bytes)
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    side = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, side


def phase_main(dev, smi):
    import numpy as np
    import torch
    from repro_torch.configs.bltc import fig4
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.core import eval as ev
    from repro_torch.core.direct import direct_sum
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    n = 1_000_000
    cfg = fig4(theta=0.7, degree=8)
    rng = np.random.default_rng(2020)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    q_np = rng.uniform(-1, 1, n).astype(np.float32)
    solver = TreecodeSolver(cfg)                       # device: cuda

    t0 = time.perf_counter()
    plan = solver.plan(x)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    st = plan.stats()
    a = plan.arrays
    print(f"[4] plan N={n} theta={cfg.theta} degree={cfg.degree} "
          f"N_L=N_B={cfg.leaf_size}: {plan_ms:.1f} ms host build "
          f"{st['build_phases']}; nodes {st['num_nodes']}, leaves "
          f"{st['num_leaves']}, batches {st['num_batches']}, depth "
          f"{st['tree_depth']}; tgt slab {tuple(a['tgt_batched'].shape)}, "
          f"approx {tuple(a['approx_idx'].shape)}, direct "
          f"{tuple(a['direct_idx'].shape)}, levels "
          f"{[tuple(g.shape) for g in a['bucket_gather']]}", flush=True)

    q = torch.as_tensor(q_np, device=dev)
    reps = 7
    # -- the main path run the launch counters read --------------------
    bcm.LAUNCHES = 0
    mcm.LAUNCHES = 0
    t0 = time.perf_counter()
    phi = plan.execute(q)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms = event_ms(lambda: plan.execute(q), reps)
    launches = {"batch_cluster": bcm.LAUNCHES,
                "modified_charges": mcm.LAUNCHES}
    calls = 1 + reps
    assert launches["batch_cluster"] >= 2 * calls, launches
    assert launches["modified_charges"] >= calls, launches
    print(f"[4] execute: cold {cold_ms:.2f} ms, warm median {warm_ms:.3f} ms "
          f"over {reps} (CUDA events); launches over {calls} executes "
          f"{launches}", flush=True)

    # accuracy against f64 direct summation on sampled targets
    sample = torch.as_tensor(rng.choice(n, 1000, replace=False), device=dev)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
    ref = direct_sum(x64[sample], x64, q.double(), kernel=solver.kernel,
                     source_chunk=1 << 15)
    err = rel2(phi[sample].double(), ref)
    assert phi.shape == (n,) and torch.isfinite(phi).all()
    assert err <= 1e-5, err
    print(f"[4] relative 2-norm error vs f64 direct sum on 1000 sampled "
          f"targets: {err:.3e} (bar 1e-5)", flush=True)

    # kernels vs plain on the real plan, on the very tensors execute
    # feeds them (eval.kernel_inputs), and their times through the same
    # ops entry points execute calls
    degree = cfg.degree
    inp = ev.kernel_inputs(a, q, degree=degree)
    mc_err = 0.0
    for _, pts, qb, lo, hi in inp.levels:
        got = ops.modified_charges(pts, qb, lo, hi, degree=degree,
                                   backend="cuda")
        want = ops.modified_charges(pts, qb, lo, hi, degree=degree,
                                    backend="torch")
        # q_hat sums bounded Lagrange terms: no entry is an outlier, so
        # atol follows max|q_hat|
        mc_err = max(mc_err, close(got, want, 3e-3, 3e-4,
                                   f"modified_charges level C={pts.shape[0]}"
                                   f" m={pts.shape[1]}", scale="max"))
    qhat = ev.compute_qhat_direct(inp.levels, a["node_lo"].shape[0],
                                  degree=degree, backend="cuda")
    lanes = {"approx": (a["approx_idx"], inp.grids, qhat),
             "direct": (a["direct_idx"], inp.leaf_pts, inp.leaf_q)}
    kern = solver.kernel
    tgt = a["tgt_batched"]
    b = tgt.shape[0]
    rows = torch.arange(0, b, max(1, b // 32), device=dev)
    bc_err = 0.0
    for lane, (idx, pts, qq) in lanes.items():
        sub_idx, sub_tgt = idx[rows], tgt[rows]
        got = ops.batch_cluster_eval(sub_idx, sub_tgt, pts, qq, kernel=kern,
                                     backend="cuda")
        want = ops.batch_cluster_eval(sub_idx, sub_tgt, pts, qq, kernel=kern,
                                      backend="torch")
        # near pairs make a few |phi| large (1/r at the smallest
        # separations), so atol follows the typical value, median|phi|
        err = close(got, want, 2e-4, 2e-4, f"batch_cluster {lane} lane rows",
                    scale="median")
        bc_err = max(bc_err, err)
        mag = want.abs()
        print(f"[4] batch_cluster {lane} lane on {rows.numel()} batch rows: "
              f"max abs err {err:.3e}; |phi| max {mag.max().item():.4e}, "
              f"median {mag.median().item():.4e}, rms "
              f"{mag.square().mean().sqrt().item():.4e} (rtol 2e-4, atol "
              f"2e-4 median|phi|)", flush=True)
    print(f"[4] on the real plan: modified_charges all {len(inp.levels)} "
          f"levels max abs err {mc_err:.3e} (rtol 3e-3, atol 3e-4 "
          f"max|q_hat|); max|phi| {phi.abs().max().item():.4e}", flush=True)

    mc_ms = event_ms(lambda: [ops.modified_charges(
        p, qb, lo, hi, degree=degree, backend="cuda")
        for _, p, qb, lo, hi in inp.levels], 5)
    mc_plain_ms = event_ms(lambda: [ops.modified_charges(
        p, qb, lo, hi, degree=degree, backend="torch")
        for _, p, qb, lo, hi in inp.levels], 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_level = []
    for _, p, qb, lo, hi in inp.levels:
        ms = event_ms(lambda: ops.modified_charges(
            p, qb, lo, hi, degree=degree, backend="cuda"), 5)
        splits = mcm.split_count(p.shape[0], p.shape[1], 256, sms)
        per_level.append(f"C={p.shape[0]} m={p.shape[1]} splits={splits}: "
                         f"{ms:.3f} ms")
    lane_ms, lane_plain_ms, lane_bound = {}, {}, {}
    leaf_counts = (a["leaf_gather"] >= 0).sum(1)
    n1c = torch.full((a["node_lo"].shape[0],), (degree + 1) ** 3,
                     device=dev)
    for lane, (idx, pts, qq) in lanes.items():
        lane_ms[lane] = event_ms(lambda: ops.batch_cluster_eval(
            idx, tgt, pts, qq, kernel=kern, backend="cuda"), 5)
        lane_plain_ms[lane] = event_ms(lambda: ops.batch_cluster_eval(
            idx, tgt, pts, qq, kernel=kern, backend="torch"), 1)
        lane_bound[lane] = bc_bound(
            plan, idx, leaf_counts if lane == "direct" else n1c, 4,
            pts.shape[0] * pts.shape[1])
    bc_bound_ms = sum(v[0] for v in lane_bound.values())
    bc_side = ("operations" if all(v[1] == "operations"
                                   for v in lane_bound.values()) else "bytes")
    mc_bound_ms, mc_side = mc_bound(plan, degree, 4)
    for lane in lanes:
        bms, side, pairs = lane_bound[lane]
        print(f"[4] batch_cluster {lane} lane: {lane_ms[lane]:.3f} ms "
              f"(plain {lane_plain_ms[lane]:.1f} ms), {pairs:.4e} pairs "
              f"needed, bound {bms:.3f} ms by {side} ({smi})", flush=True)
    print(f"[4] modified_charges, {len(inp.levels)} levels: {mc_ms:.3f} ms "
          f"(plain {mc_plain_ms:.1f} ms), bound {mc_bound_ms:.4f} ms by "
          f"{mc_side} ({smi}); by level: {'; '.join(per_level)}",
          flush=True)

    report = [
        dict(name="batch_cluster", route="cuda",
             source="src/repro_torch/kernels/csrc/batch_cluster.cu",
             replaces="src/repro/kernels/batch_cluster.py:145",
             launches=launches["batch_cluster"], max_abs_err=bc_err,
             ms=sum(lane_ms.values()), plain_ms=sum(lane_plain_ms.values()),
             bound_ms=bc_bound_ms, bound_by=bc_side, library_ms=None),
        dict(name="modified_charges", route="cuda",
             source="src/repro_torch/kernels/csrc/modified_charges.cu",
             replaces="src/repro/kernels/modified_charges.py:65",
             launches=launches["modified_charges"], max_abs_err=mc_err,
             ms=mc_ms, plain_ms=mc_plain_ms, bound_ms=mc_bound_ms,
             bound_by=mc_side, library_ms=None),
    ]
    return plan, x, q, report


def phase_yukawa(dev, plan, x, q):
    import numpy as np
    import torch
    from repro_torch.core.api import SingleDevicePlan
    from repro_torch.core.direct import direct_sum
    from repro_torch.core.potentials import yukawa
    from repro_torch.kernels import _build

    cfg = dataclasses.replace(plan.config, kernel="yukawa",
                              kernel_params={"kappa": 0.5})
    yplan = SingleDevicePlan(cfg, cfg.make_kernel(), plan.inner, plan.dtype)
    libs_before = dict(_build._LIBS)
    built_before = dict(_build.BUILD_SECONDS)
    kappas = [torch.tensor(k, dtype=plan.dtype, device=dev)
              for k in (0.5, 1.0)]
    yplan.execute(q, kernel_params={"kappa": kappas[0]})    # warm
    torch.cuda.synchronize()
    phis = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in kappas:
            phis.append(yplan.execute(q, kernel_params={"kappa": k}))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _build._LIBS == libs_before, "a kernel library was reloaded"
    assert _build.BUILD_SECONDS == built_before, "a kernel was rebuilt"
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        x.shape[0], 500, replace=False), device=dev)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
    errs = []
    for kv, phi in zip((0.5, 1.0), phis):
        ref = direct_sum(x64[sample], x64, q.double(), kernel=yukawa(kv),
                         source_chunk=1 << 15)
        errs.append(rel2(phi[sample].double(), ref))
        assert errs[-1] <= 1e-5, (kv, errs[-1])
    assert not torch.equal(phis[0], phis[1])
    print(f"[5] yukawa sweep kappa 0.5 -> 1.0 on the same geometry: no "
          f"rebuild, no host sync; rel 2-norm errors on 500 targets "
          f"{errs[0]:.3e}, {errs[1]:.3e}", flush=True)


def phase_periodic(dev):
    import numpy as np
    import torch
    from repro_torch.core.api import TreecodeConfig, TreecodeSolver
    from repro_torch.core.direct import direct_sum
    from repro_torch.core.space import PeriodicBox
    from repro_torch.kernels import batch_cluster as bcm

    n = 200_000
    # points inside the primary cell, so the plan's f32 wrap is exact and
    # the f64 oracle sees the very coordinates the treecode does
    box = PeriodicBox((2.0, 2.0, 2.0))
    rng = np.random.default_rng(77)
    x = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    q_np = rng.uniform(-1, 1, n).astype(np.float32)
    cfg = TreecodeConfig(theta=0.7, degree=8, leaf_size=2000, space=box,
                         skin=0.02)
    solver = TreecodeSolver(cfg)
    plan = solver.plan(x)
    q = torch.as_tensor(q_np, device=dev)
    before = bcm.LAUNCHES
    phi = plan.execute(q)
    torch.cuda.synchronize()
    assert bcm.LAUNCHES > before
    sample = torch.as_tensor(rng.choice(n, 1000, replace=False), device=dev)
    assert np.array_equal(box.wrap(x), x)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
    ref = direct_sum(x64[sample], x64, q.double(), kernel=solver.kernel,
                     space=box, source_chunk=1 << 14)
    err = rel2(phi[sample].double(), ref)
    skin_slots = int((plan.arrays["skin_direct"] >= 0).sum())
    assert torch.isfinite(phi).all() and err <= 1e-5, err
    print(f"[6] periodic box L=2, skin 0.02, N={n}: rel 2-norm error vs f64 "
          f"minimum-image direct sum on 1000 targets {err:.3e} (bar 1e-5); "
          f"{skin_slots} skin-direct slots gated", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "kernels", "csrc")):
        print("chip_smoke: run from a checkout of the repository (src/"
              "repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"[1] {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}) "
          f"on {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s "
          f"{ {k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()} }",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line and " 0 bytes" not in line:
                print(f"    {name}: {line.strip()}")

    phase_batch_cluster(dev)
    phase_modified_charges(dev)
    plan, x, q, report = phase_main(dev, smi)
    phase_yukawa(dev, plan, x, q)
    del plan
    phase_periodic(dev)
    print(f"[7] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

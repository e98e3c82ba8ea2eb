#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):

 1. device line (nvidia-smi name and power limit), torch version, and the
    build of every CUDA kernel from `src/repro_torch/kernels/csrc/`
    (one nvcc per source, started together);
 2. batch_cluster kernel vs its plain PyTorch version (phases 2, 2f, 2g
    and 3 end with their kernel's systems-axis cases, SYSTEMS_W stacked
    systems against the plain version and each against its own
    single-system launch): interior -1
    slots, an all-empty row, a coincident target/source pair, ragged
    NB and m, free and periodic space, Coulomb and Yukawa at two kappas,
    Kahan and the matmul-r2 form, each without and with target and
    source counts (ragged, a row and a cluster with count 0, full
    counts, counts off the unroll and the tile; phi must be exactly 0 on
    padded target slots); f32 rtol/atol 2e-4, f64 rtol 1e-12 (f64 cases
    use positive charges, so no entry cancels towards 0);
 3. modified_charges kernel vs its plain version at degrees 1, 4, 8, 14:
    the dense (C, m) form with random points, exact hits on the nodes and
    center-filled padding, and the ranged form over ragged node ranges
    (counts 0 and 1, at the tile and at the chunk size, a node spanning
    the others), two launches a call and bitwise equal calls; f32 rtol
    3e-3 / atol 3e-4, f64 rtol 1e-10 / atol 1e-12 times max|q_hat|
    (signed sums over up to 4096 particles; the ranged atol is relative
    to max|q_hat| in f32 too: its sums run over 12,000 particles); and
    nodes flat in one, two and three dimensions (lo == hi: every particle
    hits all n+1 coincident nodes), each node's q_hat summing to its
    charge (1e-4 f32, 1e-11 f64 of sum|q|);
 4. the main path: the paper's Fig. 4 setting (theta 0.7, degree 8,
    N_L = N_B = 2000, Coulomb, f32) at N = 10^6 uniform in [-1,1]^3
    with charges uniform in [-1,1]. Plan, one cold and 7 warm
    executes (CUDA events), the relative 2-norm error against an f64
    direct sum on 1000 sampled targets (<= 1e-5), both lanes' kernels
    and the modified charges against their plain versions on the
    tensors execute feeds them (there the atol is relative to
    max|q_hat| or median|phi|: the sums run over up to 10^6 terms), and
    the launch counters of the run (modified charges: two launches per
    execute, the chunk kernel and the per-node sum); the modified
    charges' chunks, particle-levels swept against needed, and the
    registers and spills of their f32 n+1 = 9 instantiation; per
    batch-cluster lane, the pairs its launch geometry sweeps beside the
    pairs the data needs, the tiles it launches beside those with a
    target, and the SM clock and power nvidia-smi reads while it runs;
 4s. the Fig. 4 setting on a sheet: SHEET_N points uniform in [-1,1]^2 at
    z = 0, every node flat in z: execute (1e-5) and forces (FORCE_BAR)
    against an f64 direct sum on 1000 sampled targets, through the host
    and the device build and the hierarchical precompute; the modified
    charges against their plain version on every node;
 5. a Yukawa sweep (kappa 0.5, then 1.0) on the same geometry with
    the kappas as device tensors: no rebuild, and no host sync
    (torch.cuda.set_sync_debug_mode("error") around the calls);
 6. a periodic box with a Verlet skin at N = 2*10^5 against an f64
    minimum-image direct sum on sampled targets;
 2f. batch_cluster_field kernel vs its plain version on phase 2's
    ragged cases (Coulomb and Yukawa, free and periodic, f32 and f64,
    Kahan, counts of 0), with exact hits (r^2 = 0) that must give 0 in
    all four outputs, and its phi against the potential kernel's; each
    gradient entry is held to GRAD_K times its own sum of the terms'
    magnitudes (the plain version's `magnitude=True` sweep);
 2g. the grid field kernel (the approximation lane's: clusters as
    Chebyshev nodes and q_hat) vs its plain version at degrees 1, 4, 8,
    14: free space, a periodic box and a box whose edge puts targets at
    minimum-image ties, Coulomb and Yukawa, f32 and f64, Kahan and
    counts on and off, -1 sentinels, an all-empty row, targets exactly
    on grid points, a zero-width cluster and a scratch node; gradient
    entries as in 2f, phi against the potential kernel's on the grid
    points per entry (PHI_K times its sum |G q|), and the plain version
    against the field kernel's plain version on those points;
 4f. Fig. 4 forces on the main phase's plan: `potential_and_forces`
    time (one field and one grid field launch a call), its phi against
    `execute` (PHI_K per entry), forces against an f64 direct sum on
    1000 sampled targets (relative 2-norm <= FORCE_BAR); per lane the
    kernel's time against its bound (the largest of FLOP, SFU and bytes
    times), the pairs its geometry sweeps and the issue slots per swept
    pair, and the kernel against its plain version (timed once over the
    whole lane) on the first FORCE_ROWS (128) of the 500 batch rows, the
    gradient per entry as in 2f, phi against `execute` on their targets
    (the magnitude sweep that sets those bars took ~95 s over every
    row); on the
    approximation lane also the generic field kernel on the same
    clusters as explicit grid points, timed in turns with the grid
    kernel: the redesign's same-run yardstick;
 8. MD at N = 10^6, the Fig. 4 settings with a Verlet skin of 0.01:
    `Simulation` over a jittered 100^3 lattice with +-1 charges,
    velocity Verlet, 20 steps, refit interval 10; steps 2-20 run with
    the launch counters at 0 (the field and the grid field kernel one
    launch a step each, the modified charges 2), exactly
    one host sync per refit step (torch.cuda.set_sync_debug_mode
    "warn", and since PR 20 one explicit pull, the drift, under
    `lint.runtime.no_implicit_syncs()`), no capacity growth and no
    kernel build after step 1; ms per
    refit and rebuild step, span times of two traced refit steps,
    refit/rebuild counts by cause, energy and momentum drift; the energy
    balance |dKE + dPE| / dKE in f64 (<= ENERGY_BAR), and the field
    kernels against their plain versions on the first 64 batch rows of
    both lanes of the MD's capacity-padded plan;
 8d. the same MD with `build_backend="device"`: the tree rebuilt on the
    card from the live positions (`repro_torch.devtree`), with phase 8's
    gates; its rebuild step beside the host's;
 8a. 8d with `async_replan=True`: shadow builds dispatched on a side
    stream on refit steps (which still make exactly one host sync) and
    swapped in a step later; the dispatch and the commit-wait ms;
 9. a periodic Yukawa MD (58^3 salt box, skin 0.02): skin gate and
    minimum-image forces through refits and a rebuild, the energy
    balance and the field kernel on the padded plan's rows as in 8,
    final forces against an f64 minimum-image direct sum;
 10. the device-built plan at Fig. 4 on phase 4's 10^6 points: cold
    build and a warm budgeted replan by phase (bitwise the first, same
    shapes, no host tree built), execute and `potential_and_forces`
    with every launch counter from 0, against an f64 direct sum on 1000
    sampled targets (1e-5, FORCE_BAR); batch_cluster and both field
    kernels against their plain versions on its first 64 batch rows,
    the modified charges on every node row; `replan_async` dispatched
    under `lint.runtime.no_implicit_syncs()` and bitwise the
    synchronous replan; at 10^5, every (target, source) pair covered
    exactly once by the device plan's lists, as by the host plan's;
 11. the hierarchical precompute at Fig. 4: q_hat against the direct
    precompute in f64 at 10^5 (rtol 1e-10, atol 1e-12 max|q_hat|),
    execute at 10^6 against an f64 direct sum (1e-5), and the
    precompute's ms beside the direct one's;
 12. serving at the Fig. 4 statics (`repro_torch.serve`): (12a) an
    EnsemblePlan of 8 systems (SERVE_SIZES, Yukawa, a kappa per system):
    execute and potential_and_forces beside the 8 single-system plans,
    the launches a call (2/2/0/0 and 0/2/1/1 whatever W is), each system
    against an f64 direct sum (1e-5, FORCE_BAR) and within 1e-6 of its
    single plan, each lane kernel on the stacked shapes against its
    bound and each kernel against its plain version on the first 64
    batch rows of every system; (12b) a 5-kappa scan over one geometry
    under torch.cuda.set_sync_debug_mode("error"); (12c) ServeFrontend
    on 24 requests, then the same 24 (compiles <= buckets x 2 kinds; the
    second pass 0 compiles, retraces and capacity growths; every request
    against a single plan); (12d) an 8-replica EnsembleMD (launches a
    step, every replica against its own Simulation(rebuild="never") and
    its energy balance); 12b, 12c (each bucket's last flush) and 12d (the
    refitted, skin-gated stack) also hold every kernel against its plain
    version on their own stacked arrays (`stacked_rows_check`);
 13. the sharded treecode (`repro_torch.distributed`), P = SHARDED_P
    ranks stacked on the one card: (13a) phase 4's 10^6 points and
    charges at Fig. 4: the host build by phase (rcb, local plans, LET
    traversal, pad, commit) and the budget; execute (median of 7) and
    `potential_and_forces` (median of 3) beside the single plan's in the
    same run, with every launch counter from 0 (4 batch-cluster and 2
    modified-charge launches an execute; 2 field, 2 grid field and 2
    modified-charge launches a force call); phi and forces against an
    f64 direct sum on 1000 sampled targets (1e-5, FORCE_BAR); each of the
    four lanes' kernels against its plain version on the first
    SHARDED_ROWS batch rows of every rank and the modified charges on
    every node (`sharded_rows_check`); the pairs each lane needs and
    sweeps beside the single plan's two lanes, and each potential lane's
    ms; (13b) a sharded MD on the lattice of SHARDED_MD_M^3 (free space,
    skin 0.01, dt 1e-5, refit interval 10, 20 steps) with phase 8's
    gates (one host sync per refit step, no growth and no kernel build
    after step 1, the energy balance) and its refit and rebuild steps;
 14. the differentiable executor (`core.eval.differentiable_execute`) on
    phase 4's plan, points and charges with a seeded cotangent u: the
    forward and the backward for the charges, the targets and both (CUDA
    events, median of 3) with the launches of each from 0 (a backward:
    batch_cluster 2 on the transposed lists, the transposed modified
    charges 1, the field kernels 1 each and the modified charges 2 for
    the targets); phi bitwise `execute`'s, the target cotangent bitwise
    u g of `potential_and_gradient`, the adjoint identity |<u, phi> -
    <qbar, q>| / (|u| |phi|) <= 1e-5; each transposed batch-cluster lane
    (the clusters' grids and the leaves as rows, the batches as sources)
    on its first DIFF_ROWS rows against the plain version (PHI_K times
    sum |G u| per entry), its S_T, time and bound; the transposed
    modified-charge kernel on the whole plan against its plain version
    (MCT_K times its sum of magnitudes per entry), bitwise equal calls,
    its time and bound, the profiler split of one call and of the tile
    table's build, the kernel's registers and spills; at DIFF_F64_N in
    f64 the adjoint identity (1e-12) and the CUDA backward against the
    "torch" backend's (rtol 1e-10, atol 1e-12 max|want|);
 15. the checking tools: (15a) `python -m repro_torch.lint
    src/repro_torch` exits 0 (hot functions, findings, reasoned
    suppressions); (15b) under `lint.runtime.no_implicit_syncs()`
    (set_sync_debug_mode("error"), with "warn" outside it so each
    explicit pull also warns as the ad hoc switches of earlier PRs
    counted) 7 warm executes and 3 warm force calls on phase 4's plan
    make no pull, 5 refit steps of phase 8's MD exactly one (the drift),
    taken in turn with 5 unguarded refit steps (the default path's
    median), a warm 12c resubmission only its plan builds, uploads and
    results,
    and a 10^6 `replan_async` dispatch none; phases 8, 8d, 8a and 10
    run their steps and dispatch under the same guard; (15c)
    `obs.transfers.count_transfers` of a warm execute (DtoH 0, HtoD 0)
    and a refit step (DtoH 1; a trace holding the pull's wait but no
    memcpy lost a record, and the next refit step is traced, up to 20);
    (15d) REPRO_DEBUG_NANS=1: 3 clean steps of
    a 46^3 MD, a NaN charge raising FloatingPointError at the modified
    charges, the execute's ms with the mode on and off; (15e) the meta
    dry run of the sharded plan's execute and potential_and_forces for
    one rank of 256 and 2 x 256 ranks of 262,144 points; and phase 4's
    execute and the unguarded refit step medians beside PR 18's;
 16. LM serving (`repro_torch.models`, plain PyTorch: no kernel): (16a)
    every arch of `configs.registry` at its SMOKE config in f32, its
    parameters materialized on the CPU and carried to the card, prefill
    of 16 tokens and 4 decode steps on the card against the same port on
    the CPU (relative 2-norm <= 1e-4), the MoE archs choosing the same
    experts; (16b) gemma-7b at its FULL config in bf16, materialized on
    the card: 4 requests of 512 prompt tokens and 32 greedy decode steps
    under `lint.runtime.no_implicit_syncs()` (0 implicit syncs), each
    step's logits against one full forward over the prompt and the
    generated tokens (relative 2-norm <= 3e-2, greedy tokens equal in
    >= 90% of the 128 steps); prefill ms, decode ms a token, tokens a
    second and peak memory beside the card's name and power limit;
    (16c) granite-moe-1b, mamba2-1.3b, zamba2-1.2b, whisper-small and
    llava-next-mistral-7b at FULL in bf16 the same way (FULL_SERVE), and
    in f32 on one request: the f32 decode against its full forward
    (F32_REL), the bf16 one within max(3e-2, twice the bf16 forward's
    error against f32), the greedy share printed; the MoE experts and its capacity dispatch at
    real sizes; llava's 8448-position prefill through the KV-chunked
    attention against the dense one;
 17. LM training (`repro_torch.optim`, `training`, `launch.train`, plain
    PyTorch: no kernel): (17a) every arch at its SMOKE config in f32, a
    MoE arch's groups one batch row: `loss_and_grads` on the card against
    the CPU (loss and every grad leaf within a relative 2-norm of 1e-5),
    three AdamW steps chained on both (each loss within 1e-5) and each
    from the CPU's previous params and state (params per leaf within
    1e-5 on the entries whose clipped gradient stays >= 1000 AdamW eps,
    the others within a sign flip's reach), grad_accum 4 against 1
    (loss 1e-5, params 5e-5), remat on against off (1e-6); (17b) the
    launcher at internlm2's SMOKE config in subprocesses: 20 steps, then
    40 from the same checkpoint directory ("resumed from step 20"),
    bitwise the uninterrupted 40-step run's step-40 checkpoint; (17c)
    internlm2-1.8b at FULL in bf16 with remat, 4 x 2048 tokens a step
    from `TokenSource`, 30 AdamW steps at lr 1e-4, 10 timed under
    `no_implicit_syncs()` (0 syncs): step 0's loss within 0.05 of its
    expectation, the last 5 steps 0.1 below it, a held batch 0.1 lower
    after training, the grad norm finite and > 0, remat on against off
    on 1 x 2048 (1e-2); step time, tokens/s, the update's share, model
    FLOPs against the bf16 peak, peak memory, a profiled step's idle
    share and the forward / backward / recompute split on 1 x 2048;
    (17d) granite-moe-1b (4 x 1024) and mamba2-1.3b (4 x 2048) at FULL,
    5 steps each, the same but the held batch alone holding the fall;
 18. the LM dry run (`repro_torch.launch.dryrun`, its op-level cost
    analysis `launch.hlo_analysis`; plain PyTorch, no kernel): (18a)
    17c's step (internlm2-1.8b FULL, 4 x 2048, bf16, remat, AdamW) dry
    run on one device as plain meta tensors, against one real step on
    the card under the same `analyze`: matmul FLOPs equal exactly,
    model_flops the reference's 6 N_active D, the dry run's arguments
    plus its peak of temporaries within [0.8, 1.25] of the real step's
    `max_memory_allocated`; the card's total memory beside the dry run's
    `HBM_BYTES`; (18b) `run_cell` for gemma-7b train_4k on the 16 x 16
    mesh and arctic-480b train_4k on the 2 x 16 x 16 one, in a
    subprocess on PyTorch's fake process group (no CUDA there; started
    before the build, it runs on the CPU during it): both `ok`,
    their dry_run_s, per-device bytes, fits_hbm, roofline terms and
    collectives printed;
 7. one JSON line per kernel (launches, error against the plain
    version, times, bound), the device line, and the final status line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import contextlib
import dataclasses
import itertools
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
PEAK_BF16 = 989e12     # dense bf16 FLOP/s on the tensor cores
# MUFU (special function unit) results per clock per SM for the f32
# reciprocal square root and base-2 exponential at compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table);
# the SFU side of a bound is MUFU operations over this rate at the SM
# clock sampled while the kernel runs (the H100's 1980 MHz without a
# sample), times the card's SMs.
SFU_PER_SM_CLOCK = 16
MAX_SM_MHZ = 1980
# Operations per (target, source) pair of the batch-cluster sum:
# 3 sub + 3 mul + 2 add (r^2), sqrt, divide, multiply by q, add.
FLOPS_PER_PAIR = 12
# Operations per pair of the field kernel (3 sub, 5 for r^2, the rsqrt,
# 2 for phi, 3 mul and 3 fma for the gradient).
FIELD_FLOPS_PER_PAIR = 20
# ... and of the grid field kernel's factored sweep (`grid_flops`): per
# pair 1 add for r^2 from its row's d_x^2 + d_y^2 and the z table, 3 mul
# (G q, rinv^2, s), the phi add, the row-sum add and the g_z fma; per row
# the add d_x^2 + d_y^2, the g_y fma and the plane-sum add; per plane the
# g_x fma; per axis point of each (target, cluster) a subtraction and a
# square.
GRID_FLOPS_PER_PAIR = 8
# MUFU operations per pair of the main path's f32 Coulomb kernels (the
# rsqrt; Yukawa adds an exponential).
MUFU_PER_PAIR = 1
# Particles of the main path (Fig. 4) and of the periodic phase.
MAIN_N = 1_000_000
PERIODIC_N = 200_000
# Relative 2-norm bar of the Fig. 4 forces against an f64 direct sum.
FORCE_BAR = 1e-4
# ... and of the periodic MD's f32 forces: on a +-1 salt lattice the net
# force is ~100x smaller than the sum of its terms' magnitudes, and an
# f32 sum keeps ~1e-7 of the latter (plain f32 direct sums over every
# pair of a 30^3 piece were 4.8e-4 / 5.5e-4 off for Yukawa / Coulomb:
# tools/md_f32_cpu.py).
# The approximation itself is held to FORCE_BAR in f64.
F32_CANCEL_BAR = 1e-3
# The MD runs: a jittered 100^3 lattice in [-1,1]^3 at the Fig. 4
# setting, and a periodic Yukawa salt box of 58^3 (about 2*10^5), both
# with +-1 charges and no repulsive core. Three limits set dt and the
# skin:
# - f32 positions: a step must move a typical particle (F ~ 500 on the
#   10^6 lattice) by many ulps of its coordinate (6e-8 near |x| = 1), or
#   the move rounds away while the velocity keeps it: at dt 5e-7 the KE
#   gained 116 and the PE fell 16;
# - the closest opposite pairs (F ~ 1e4) fall together in ~4e-4 time
#   units, so 20 steps must end well before that;
# - at skin 0 the Fig. 4 plan at 10^6 allows ~8e-7 of drift a step
#   before a refit is no longer provably MAC-valid; a Verlet skin floors
#   that budget at skin / 2.
# So the 10^6 run takes dt 1e-5 and a skin of 0.01 (Fig. 4's theta,
# degree, N_L, N_B, kernel and dtype otherwise), the periodic box dt 2e-5
# (weaker forces on a coarser lattice, coordinates up to 2).
MD_M, MD_STEPS, MD_DT, MD_REFIT, MD_SKIN = 100, 20, 1e-5, 10, 0.01
PMD_M, PMD_DT, PMD_L, PMD_KAPPA = 58, 2e-5, 2.0, 1.0
MD_JITTER = 0.08                       # of the lattice spacing
# Bar of |dKE + dPE| / dKE over an MD run (`energy_balance`): forces of
# the wrong sign or twice their size give 2 or 0.5, zero forces dKE = 0.
# Measured on an H100: 6.5e-6 (10^6 lattice), 3.4e-5 (periodic box).
ENERGY_BAR = 1e-3


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


def profile_split(fn, reps, classify):
    """Where one call of `fn()` spends its time, from a `torch.profiler`
    trace of `reps` calls (each drained before the next; medians over
    the calls, in ms): ``host`` the call's span on the host (enqueue of
    every launch), ``first_op`` from the call's start on the host to its
    first device operation, ``span`` from there to its last device
    operation's end, ``busy`` the device operations' summed time,
    ``gap`` span - busy (the device idle inside the call, waiting for the
    host), ``total`` the call's start on the host to its last device
    end, and ``ops`` {category: ms, launches}, where `classify(name,
    cat)` names each device operation's category (kernels, memsets,
    copies). Raises if the trace holds no device operation."""
    import json
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    tag = "profile_split_call"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            with record_function(f"{tag}_{i}"):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    calls = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if str(e.get("name", "")).startswith(tag)
                   and not str(e.get("cat", "")).startswith("gpu"))
    dev_ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memset", "gpu_memcpy")]
    rows = []
    for i, (s, e) in enumerate(calls):
        nxt = calls[i + 1][0] if i + 1 < len(calls) else float("inf")
        mine = [o for o in dev_ops if s <= o["ts"] < nxt]
        if not mine:
            continue
        first = min(o["ts"] for o in mine)
        last = max(o["ts"] + o.get("dur", 0) for o in mine)
        ops = {}
        for o in mine:
            key = classify(o.get("name", ""), o.get("cat", ""))
            if key is not None:
                ms, n = ops.get(key, (0.0, 0))
                ops[key] = (ms + o.get("dur", 0) / 1e3, n + 1)
        busy = sum(o.get("dur", 0) for o in mine) / 1e3
        rows.append(dict(host=(e - s) / 1e3, first_op=(first - s) / 1e3,
                         span=(last - first) / 1e3, busy=busy,
                         gap=(last - first) / 1e3 - busy,
                         total=(last - s) / 1e3, ops=ops))
    assert rows, "the profiler saw no device operation"
    out = {k: statistics.median(r[k] for r in rows)
           for k in ("host", "first_op", "span", "busy", "gap", "total")}
    keys = sorted({k for r in rows for k in r["ops"]})
    out["ops"] = {k: (statistics.median(r["ops"].get(k, (0.0, 0))[0]
                                        for r in rows),
                      max(r["ops"].get(k, (0.0, 0))[1] for r in rows))
                  for k in keys}
    out["calls"] = len(rows)
    return out


def split_text(sp):
    """One line of `profile_split`'s result."""
    ops = "; ".join(f"{k} {ms:.4f} ms ({n} op{'s' if n != 1 else ''})"
                    for k, (ms, n) in sp["ops"].items())
    return (f"host enqueue {sp['host']:.4f} ms, host start to first device "
            f"op {sp['first_op']:.4f} ms, device span {sp['span']:.4f} ms "
            f"= busy {sp['busy']:.4f} ms [{ops}] + idle gaps "
            f"{sp['gap']:.4f} ms; host start to device end "
            f"{sp['total']:.4f} ms (median of {sp['calls']} calls)")


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
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops

    lib = _build.load("batch_cluster", bcm._SIGNATURES)
    assert (lib.bc_geometry(0), lib.bc_geometry(1)) == (
        bcm._TARGETS_PER_BLOCK, bcm._SOURCE_UNROLL), "geometry constants"
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
                        for r2, counts in itertools.product(
                                ("diff", "matmul") if not space.periodic
                                else ("diff",), (False, True)):
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
                            if counts:
                                kw.update(count_case(rng, B, NB, C, m, dev))
                            got = ops.batch_cluster_eval(
                                it, *t, backend="cuda", **kw)
                            want = ops.batch_cluster_eval(
                                it, *t, backend="torch", **kw)
                            what = (f"batch_cluster {dtype} {(B, S, NB, C, m)}"
                                    f" {space} {kern.name}{kern.params} "
                                    f"kahan={kahan} r2={r2} counts={counts}")
                            err = close(got, want, rtol, atol, what)
                            worst[dtype] = max(worst[dtype], err)
                            if B > 1:
                                assert (got[0] == 0).all(), what
                            if counts:
                                pad = (torch.arange(NB, device=dev)[None]
                                       >= kw["tgt_count"][:, None])
                                assert (got[pad] == 0).all(), what
                            n += 1
    torch.cuda.synchronize()
    print(f"[2] batch_cluster vs plain: {n} cases ok; max abs err "
          f"f32 {worst[torch.float32]:.3e} (rtol/atol 2e-4), f64 "
          f"{worst[torch.float64]:.3e} (rtol 1e-12)", flush=True)
    print_systems_axis("[2]", "batch_cluster", dev)


def phase_field(dev):
    """The field kernel against its plain version on ragged cases, exact
    hits included, and its phi against the potential kernel's."""
    import numpy as np
    import torch
    from repro_torch.core.potentials import coulomb, yukawa
    from repro_torch.core.space import FREE, PeriodicBox
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops

    lib = _build.load("batch_cluster_field", bcm.FIELD_SIGNATURES)
    assert (lib.bcf_geometry(0), lib.bcf_geometry(1)) == (
        bcm._TARGETS_PER_BLOCK, bcm._SOURCE_UNROLL), "geometry constants"
    rng = np.random.default_rng(13)
    box = PeriodicBox((1.5, 2.0, 1.7), origin=(-0.75, -1.0, -0.85))
    n = 0
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    worst_ratio = dict(worst)
    phi_worst = 0.0
    for dtype in (torch.float32, torch.float64):
        rtol, atol = FIELD_TOL[dtype.itemsize]
        qlo = -1.0 if dtype == torch.float32 else 0.0
        for (B, S, NB, C, m) in [(5, 9, 300, 11, 700), (3, 4, 40, 5, 24),
                                 (2, 3, 129, 3, 257), (1, 1, 8, 1, 8)]:
            for space, kern, kahan, counts in itertools.product(
                    (FREE, box), (coulomb(), yukawa(0.5), yukawa(1.7)),
                    (False, True), (False, True)):
                tgt = rng.uniform(-1, 1, (B, NB, 3))
                src = rng.uniform(-1, 1, (C, m, 3))
                q = rng.uniform(qlo, 1, (C, m))
                idx = rng.integers(-1, C, (B, S))
                idx[:, S // 2] = -1                  # interior sentinel
                if B > 1:
                    idx[0] = -1                      # all-empty row
                k = min(NB, m, 3)
                tgt[-1, :k] = src[0, :k]             # exact hits
                idx[-1, 0] = 0
                t = [torch.as_tensor(a, dtype=dtype, device=dev)
                     for a in (tgt, src, q)]
                it = torch.as_tensor(idx, dtype=torch.int32, device=dev)
                kw = dict(kernel=kern, space=space, kahan=kahan)
                if counts:
                    kw.update(count_case(rng, B, NB, C, m, dev))
                before = bcm.FIELD_LAUNCHES
                got = ops.batch_cluster_field(it, *t, backend="cuda", **kw)
                assert bcm.FIELD_LAUNCHES == before + 1, "one launch a call"
                want = ops.batch_cluster_field(it, *t, backend="torch", **kw)
                mag = bcm.batch_cluster_field_plain(it, *t, magnitude=True,
                                                    **kw)
                what = (f"batch_cluster_field {dtype} {(B, S, NB, C, m)} "
                        f"{space} {kern.name}{kern.params} kahan={kahan} "
                        f"counts={counts}")
                err, ratio = field_close(got, want, mag, rtol, atol, what)
                worst[dtype] = max(worst[dtype], err)
                worst_ratio[dtype] = max(worst_ratio[dtype], ratio)
                phi = ops.batch_cluster_eval(it, *t, backend="cuda", **kw)
                phi_worst = max(phi_worst, close(
                    got[..., 0], phi, *FIELD_PHI_TOL[dtype.itemsize],
                    f"{what}: field phi vs potential kernel"))
                if B > 1:
                    assert (got[0] == 0).all(), what
                if counts:
                    pad = (torch.arange(NB, device=dev)[None]
                           >= kw["tgt_count"][:, None])
                    assert (got[pad] == 0).all(), what
                n += 1
    # a lone particle meeting itself: exactly 0 in all four outputs
    hits = 0
    for dtype, space, kern in itertools.product(
            (torch.float32, torch.float64), (FREE, box),
            (coulomb(), yukawa(0.5))):
        x = torch.as_tensor(rng.uniform(-0.7, 0.7, (1, 1, 3)), dtype=dtype,
                            device=dev)
        it = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        got = ops.batch_cluster_field(it, x, x.clone(),
                                      torch.ones((1, 1), dtype=dtype,
                                                 device=dev),
                                      kernel=kern, space=space,
                                      backend="cuda")
        assert (got == 0).all(), f"exact hit {dtype} {space} {kern.name}"
        hits += 1
    torch.cuda.synchronize()
    print(f"[2f] batch_cluster_field vs plain: {n} cases ok; max abs err "
          f"f32 {worst[torch.float32]:.3e}, f64 {worst[torch.float64]:.3e} "
          f"(phi rtol/atol {FIELD_TOL[4]} f32, rtol {FIELD_TOL[8][0]} f64; "
          f"gradient atol GRAD_K * sum|terms| per entry, GRAD_K "
          f"{GRAD_K[4]} f32, {GRAD_K[8]} f64); gradient max abs err / "
          f"sum|terms| f32 {worst_ratio[torch.float32]:.3e}, f64 "
          f"{worst_ratio[torch.float64]:.3e}; "
          f"{hits} lone exact hits give 0 in all four outputs; field phi vs "
          f"the potential kernel's max abs err {phi_worst:.3e}", flush=True)
    print_systems_axis("[2f]", "field", dev)


def fold_ties(length):
    """f32 displacements d near a minimum-image tie of a box edge `length`
    (d / L near a half-integer) where rint(d * (1/L)) and rint(d / L)
    pick different images: there the gradient component's sign depends
    on the fold."""
    import numpy as np
    L = np.float32(length)
    out = []
    for h in (0.5, -0.5, 1.5):
        lo = hi = np.float32(h * float(L))
        ds = [lo]
        for _ in range(16):
            lo = np.nextafter(lo, np.float32(-9))
            hi = np.nextafter(hi, np.float32(9))
            ds += [lo, hi]
        ds = np.array(ds, np.float32)
        out += list(ds[np.rint(ds * (np.float32(1) / L)) != np.rint(ds / L)])
    return np.array(out, np.float32)


def phase_field_grid(dev):
    """The grid field kernel against its plain version on ragged cases:
    degrees 1, 4, 8, 14; free space, a periodic box, and a box whose x
    edge puts targets at minimum-image ties of a cluster of zero width
    in x; Coulomb and Yukawa at two kappas; f32 and f64; Kahan and target
    counts on and off; -1 sentinels, an all-empty row, targets exactly on
    grid points, and a scratch node (a unit box with q_hat 0). Also its
    phi against the potential kernel's on the same clusters as grid
    points (PHI_K per entry), and the plain version against the field
    kernel's plain version on those points."""
    import numpy as np
    import torch
    from repro_torch.core import cheby
    from repro_torch.core.potentials import coulomb, yukawa
    from repro_torch.core.space import FREE, PeriodicBox
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops

    lib = _build.load("batch_cluster_field_grid", bcm.GRID_FIELD_SIGNATURES)
    for size in (4, 8):
        assert [lib.bcfg_tile(size, n1) for n1 in range(1, 17)] == [0] + [
            bcm.grid_tile(size, n1) for n1 in range(2, 16)] + [0], "tiles"
    rng = np.random.default_rng(17)
    box = PeriodicBox((1.5, 2.0, 1.7), origin=(-0.75, -1.0, -0.85))
    tie_len = 1.7778428792953491
    tie = PeriodicBox((tie_len, 7.0, 7.0))
    ties = fold_ties(tie_len)
    n = 0
    worst = {torch.float32: [0.0, 0.0, 0.0], torch.float64: [0.0, 0.0, 0.0]}
    for dtype, degree, space, kern, kahan, counts in itertools.product(
            (torch.float32, torch.float64), (1, 4, 8, 14), (FREE, box, tie),
            (coulomb(), yukawa(0.5), yukawa(1.7)), (False, True),
            (False, True)):
        rtol, atol = FIELD_TOL[dtype.itemsize]
        qlo = -1.0 if dtype == torch.float32 else 0.0
        B, S, NB, C = 4, 6, 150, 7
        n1 = degree + 1
        lo = rng.uniform(-1, 0.5, (C, 3))
        hi = lo + rng.uniform(0.1, 0.5, (C, 3))
        lo[-1], hi[-1] = 0.0, 1.0          # the scratch node
        if space is tie:
            lo[0, 0] = hi[0, 0] = 0.0      # every node of cluster 0 at x = 0
        else:
            hi[1, 2] = lo[1, 2]            # zero width in z
        lo_t, hi_t = (torch.as_tensor(v, dtype=dtype, device=dev)
                      for v in (lo, hi))
        nodes = ops._cluster_nodes(lo_t, hi_t, degree).contiguous()
        pts = cheby.cluster_grid(lo_t, hi_t, degree)
        qh = torch.as_tensor(rng.uniform(qlo, 1, (C, n1 ** 3)), dtype=dtype,
                             device=dev)
        qh[-1] = 0.0
        tgt = torch.as_tensor(rng.uniform(-1, 1, (B, NB, 3)), dtype=dtype,
                              device=dev)
        tgt[-1, :3] = pts[0, [0, n1 ** 3 // 2, n1 ** 3 - 1]]   # exact hits
        idx = rng.integers(-1, C, (B, S))
        idx[:, S // 2] = -1                # interior sentinel
        idx[0] = -1                        # all-empty row
        idx[-1, :2] = (0, C - 1)           # the hits' cluster, the scratch
        if space is tie:                   # x displacements at the ties
            k = min(len(ties), NB)
            tgt[-2, :k, 0] = torch.as_tensor(ties[:k], dtype=dtype)
            idx[-2, 0] = 0
        it = torch.as_tensor(idx, dtype=torch.int32, device=dev)
        kw = dict(kernel=kern, space=space, kahan=kahan)
        if counts:
            tc = rng.integers(0, NB + 1, B)
            tc[1], tc[-1] = NB, NB         # the hits and the ties are real
            kw["tgt_count"] = torch.as_tensor(tc, dtype=torch.int32,
                                              device=dev)
        args = (it, tgt, nodes, qh)
        before = bcm.GRID_FIELD_LAUNCHES
        got = ops.batch_cluster_field_grid(*args, backend="cuda", **kw)
        assert bcm.GRID_FIELD_LAUNCHES == before + 1, "one launch a call"
        want = ops.batch_cluster_field_grid(*args, backend="torch", **kw)
        mag = bcm.batch_cluster_field_grid_plain(*args, magnitude=True, **kw)
        what = (f"batch_cluster_field_grid {dtype} degree={degree} {space} "
                f"{kern.name}{kern.params} kahan={kahan} counts={counts}")
        err, ratio = field_close(got, want, mag, rtol, atol, what)
        # the plain version against the field kernel's on the grid points
        ref = bcm.batch_cluster_field_plain(it, tgt, pts, qh, **kw)
        field_close(want, ref, mag, rtol, atol, f"{what}: plain vs points")
        phi = ops.batch_cluster_eval(it, tgt, pts, qh, backend="cuda", **kw)
        _, phi_ratio = phi_close(got[..., 0], phi, mag[..., 0],
                                 f"{what}: phi vs potential kernel")
        for j, v in enumerate((err, ratio, phi_ratio)):
            worst[dtype][j] = max(worst[dtype][j], v)
        assert (got[0] == 0).all(), what
        if counts:
            pad = (torch.arange(NB, device=dev)[None]
                   >= kw["tgt_count"][:, None])
            assert (got[pad] == 0).all(), what
        n += 1
    torch.cuda.synchronize()
    f32, f64 = worst[torch.float32], worst[torch.float64]
    print(f"[2g] batch_cluster_field_grid vs plain: {n} cases ok (degrees 1,"
          f" 4, 8, 14; {len(ties)} tie displacements); max abs err f32 "
          f"{f32[0]:.3e}, f64 {f64[0]:.3e} (phi rtol/atol {FIELD_TOL[4]} "
          f"f32, rtol {FIELD_TOL[8][0]} f64; gradient GRAD_K * sum|terms| "
          f"per entry); gradient max err / sum|terms| f32 {f32[1]:.3e}, f64 "
          f"{f64[1]:.3e}; phi vs the potential kernel on the grid points, "
          f"max err / sum|G q| f32 {f32[2]:.3e}, f64 {f64[2]:.3e} (PHI_K "
          f"{PHI_K[4]} f32, {PHI_K[8]} f64)", flush=True)
    print_systems_axis("[2g]", "grid_field", dev)


#: (rtol, atol) of the field kernel's phi against its plain version:
#: phase 2's (f64 cases take positive charges, so phi's atol is 0).
FIELD_TOL = {4: (2e-4, 2e-4), 8: (1e-12, 0.0)}   # by itemsize
#: A gradient component sums signed terms (d changes sign), so one that
#: cancels keeps the rounding of its larger terms: each entry is held to
#: GRAD_K times its own sum of the terms' magnitudes, sum_j |2 G' d_k q_j|
#: (the plain version's `magnitude=True` sweep), by itemsize.
GRAD_K = {4: 1e-5, 8: 1e-13}
#: (rtol, atol) of the field kernel's phi against the potential kernel's:
#: the same expression in the same order, so they agree to rounding.
FIELD_PHI_TOL = {4: (1e-6, 1e-6), 8: (1e-14, 0.0)}
#: The grid field kernel sums phi in another order than the potential
#: kernel (a warp's planes of a cluster, rows of n+1 points), so its phi,
#: and the force sweep's against `execute`'s, is held per entry to PHI_K
#: times its own sum of the terms' magnitudes, sum |G q| (the plain
#: versions' `magnitude=True` sweeps), as the gradient is to GRAD_K.
#: Measured on an H100: 1.9e-7 (f32) and 1.3e-15 (f64) on phase 2g's
#: cases, 9.4e-9 against `execute` at Fig. 4.
PHI_K = {4: 1e-6, 8: 1e-14}


def phi_close(got, want, mag, what):
    """Asserts |got - want| <= PHI_K * mag per entry, `mag` the sum of
    |G q| over phi's terms; returns (max abs err, max err / mag)."""
    import torch
    assert torch.isfinite(got).all(), f"{what}: non-finite phi"
    k = PHI_K[got.element_size()]
    err = (got - want).abs()
    bad = err > k * mag
    ratio = (err / mag)[mag > 0]
    ratio = ratio.max().item() if ratio.numel() else 0.0
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} phi entries outside {k} * sum|G q| (max "
        f"abs err {err.max().item():.3e}, max err / sum|G q| {ratio:.3e})")
    return err.max().item(), ratio


def field_close(got, want, mag, rtol, atol, what, phi_scale=None):
    """`close` for (..., 4) field outputs: phi with (rtol, atol) (atol
    scaled by `phi_scale`, as in `close`), each gradient entry with
    `grad_close`. Returns (max abs err, the gradient's max err / mag)."""
    err = close(got[..., 0], want[..., 0], rtol, atol, f"{what}: phi",
                scale=phi_scale)
    gerr, ratio = grad_close(got[..., 1:], want[..., 1:], mag[..., 1:],
                             what)
    return max(err, gerr), ratio


def grad_close(got, want, mag, what):
    """Asserts |got - want| <= GRAD_K * mag per entry, `mag` the sum of
    the terms' magnitudes; returns (max abs err, max err / mag)."""
    import torch
    assert torch.isfinite(got).all(), f"{what}: non-finite gradient"
    k = GRAD_K[got.element_size()]
    err = (got - want).abs()
    bad = err > k * mag
    ratio = (err / mag)[mag > 0]
    ratio = ratio.max().item() if ratio.numel() else 0.0
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} gradient entries outside {k} * "
        f"sum|terms| (max abs err {err.max().item():.3e}, max err / "
        f"sum|terms| {ratio:.3e})")
    return err.max().item(), ratio


def count_case(rng, B, NB, C, m, dev):
    """Target and source counts for a phase-2 case: ragged, row 0 and the
    last cluster empty, row 1 and cluster 0 full."""
    import torch
    tc = rng.integers(0, NB + 1, B)
    sc = rng.integers(0, m + 1, C)
    tc[0] = 0
    sc[-1] = 0
    if B > 1:
        tc[1] = NB
    if C > 1:
        sc[0] = m
    return {"tgt_count": torch.as_tensor(tc, dtype=torch.int32, device=dev),
            "src_count": torch.as_tensor(sc, dtype=torch.int32, device=dev)}


#: Systems of a stacked case (`systems_axis_cases`).
SYSTEMS_W = 4


def stacked_case(rng, dtype, dev, B=5, S=7, NB=150, C=8, m=200):
    """Operands of SYSTEMS_W systems with a leading systems axis, as an
    ensemble stacks them: ragged per-system target and source counts, an
    interior -1 slot, system 1 a dummy slot (all charges 0) and the last
    batch row of every system a point-padded scratch row (count 0).
    Returns (idx, tgt, src, q, tgt_count, src_count, kappas (W,))."""
    import torch
    W = SYSTEMS_W
    qlo = -1.0 if dtype == torch.float32 else 0.0

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    idx = rng.integers(-1, C, (W, B, S))
    idx[:, :, S // 2] = -1
    q = rng.uniform(qlo, 1, (W, C, m))
    q[1] = 0.0
    tc = rng.integers(0, NB + 1, (W, B))
    tc[:, 0] = NB
    tc[:, -1] = 0
    sc = rng.integers(0, m + 1, (W, C))
    return (i32(idx), t(rng.uniform(-1, 1, (W, B, NB, 3))),
            t(rng.uniform(-1, 1, (W, C, m, 3))), t(q), i32(tc), i32(sc),
            t(rng.uniform(0.5, 2.0, W)))


def systems_axis_cases(dev, kind):
    """A kernel (`kind`: "batch_cluster", "field", "grid_field" or
    "modified_charges") on stacked operands of SYSTEMS_W systems against
    its plain version (the tolerances of its phase), f32 and f64, free
    space and a periodic box, Coulomb and Yukawa with a kappa per system:
    one launch a call, the scratch rows and the dummy slot exactly 0, and
    each system bitwise its own single-system launch. Returns (cases,
    max abs err)."""
    import numpy as np
    import torch
    from repro_torch.core.potentials import coulomb, yukawa
    from repro_torch.core.space import FREE, PeriodicBox
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    rng = np.random.default_rng(31)
    box = PeriodicBox((1.5, 2.0, 1.7), origin=(-0.75, -1.0, -0.85))
    n, worst = 0, 0.0
    if kind == "modified_charges":
        lib = _build.load("modified_charges", mcm._SIGNATURES)
        for dtype, degree in itertools.product(
                (torch.float32, torch.float64), (4, 8)):
            rtol, atol = ((3e-3, 3e-4) if dtype == torch.float32
                          else (1e-10, 1e-12))
            tile = lib.mc_tile(dtype.itemsize, degree + 1)
            cases = [ranged_case(rng, dtype, degree, dev, tile)
                     for _ in range(SYSTEMS_W)]
            args = [torch.stack([c[j] for c in cases]) for j in range(6)]
            args[1][1] = 0.0                        # a dummy slot
            before = mcm.LAUNCHES
            got = ops.modified_charges_ranged(*args, degree=degree,
                                              backend="cuda")
            assert mcm.LAUNCHES == before + 2, "two launches a call"
            want = ops.modified_charges_ranged(*args, degree=degree,
                                               backend="torch")
            what = f"modified_charges W={SYSTEMS_W} {dtype} degree={degree}"
            worst = max(worst, close(got, want, rtol, atol, what,
                                     scale="max"))
            assert (got[1] == 0).all(), f"{what}: dummy slot"
            for w in range(SYSTEMS_W):
                one = ops.modified_charges_ranged(
                    *(a[w] for a in args), degree=degree, backend="cuda")
                assert torch.equal(got[w], one), f"{what}: system {w}"
            n += 1
        return n, worst
    degree = 8
    for dtype, space, kern in itertools.product(
            (torch.float32, torch.float64), (FREE, box),
            (coulomb(), yukawa())):
        idx, tgt, src, q, tc, sc, kappa = stacked_case(rng, dtype, dev)
        params = (kappa,) if kern.params else None
        kw = dict(kernel=kern, space=space, tgt_count=tc)
        if kind == "grid_field":
            lo = src.amin(2)
            hi = src.amax(2)
            src = ops._cluster_nodes(lo, hi, degree).contiguous()
            # f64 cases take positive charges, as in phase 2g
            qlo = -1.0 if dtype == torch.float32 else 0.0
            q = torch.as_tensor(rng.uniform(qlo, 1, (SYSTEMS_W, lo.shape[1],
                                                     (degree + 1) ** 3)),
                                dtype=dtype, device=dev)
            q[1] = 0.0
            op, counter = ops.batch_cluster_field_grid, "GRID_FIELD_LAUNCHES"
        else:
            kw["src_count"] = sc
            op, counter = ((ops.batch_cluster_eval, "LAUNCHES")
                           if kind == "batch_cluster"
                           else (ops.batch_cluster_field, "FIELD_LAUNCHES"))
        args = (idx, tgt, src, q, params)
        before = getattr(bcm, counter)
        got = op(*args, backend="cuda", **kw)
        assert getattr(bcm, counter) == before + 1, "one launch a call"
        want = op(*args, backend="torch", **kw)
        what = (f"{kind} W={SYSTEMS_W} {dtype} {space} {kern.name} "
                f"per-system kappas")
        if kind == "batch_cluster":
            rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 \
                else (1e-12, 0.0)
            err = close(got, want, rtol, atol, what)
        else:
            plain = (bcm.batch_cluster_field_grid_plain if kind ==
                     "grid_field" else bcm.batch_cluster_field_plain)
            mag = plain(*args, magnitude=True, **kw)
            err, _ = field_close(got, want, mag, *FIELD_TOL[dtype.itemsize],
                                 what)
        worst = max(worst, err)
        assert (got[:, -1] == 0).all(), f"{what}: scratch batch row"
        assert (got[1] == 0).all(), f"{what}: dummy slot"
        for w in range(SYSTEMS_W):
            one = op(idx[w], tgt[w], src[w], q[w],
                     None if params is None else (kappa[w],), backend="cuda",
                     **{k: (v[w] if isinstance(v, torch.Tensor) else v)
                        for k, v in kw.items()})
            assert torch.equal(got[w], one), f"{what}: system {w}"
        n += 1
    return n, worst


def smi_sampler():
    """Start nvidia-smi sampling the SM clock and power every 100 ms."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def smi_samples(proc):
    """Stop a sampler; (median SM clock MHz, median power W, samples),
    or None without samples."""
    proc.terminate()
    try:
        out, _ = proc.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    rows = []
    for line in out.strip().splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:                  # "[N/A]" or a torn line
            continue
    rows = [r for r in rows if len(r) == 2]
    if not rows:
        return None
    return (statistics.median(r[0] for r in rows),
            statistics.median(r[1] for r in rows), len(rows))


def sass_inner_loop(lib_path, symbol):
    """Instructions per pair of the pair loop of one kernel variant, read
    from its SASS (cuobjdump). Each backward branch is a loop; a loop's
    own instructions are those of its body outside the loops nested in
    it, and MUFU.RSQ marks a pair. Of the loops with the most pairs of
    their own (the unrolled sweep: a chunk of sources, or a grid kernel's
    unchecked plane), the one with the fewest instructions of its own
    (the unpredicated one). Returns (instructions, pairs) or None where
    cuobjdump is missing."""
    import re
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = symbol in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, ins in body:
        m = re.search(r"BRA (?:`\(\S+\) )?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for lo, hi in loops:
        nested = [(a, b) for a, b in loops
                  if lo <= a and b <= hi and (a, b) != (lo, hi)]
        own = [i for a, i in body if lo <= a <= hi
               and not any(x <= a <= y for x, y in nested)]
        mufu = sum("MUFU.RSQ" in i for i in own)
        if mufu and (best is None or (mufu, -len(own)) > (best[1],
                                                          -best[0])):
            best = (len(own), mufu)
    return best


def phase_modified_charges(dev):
    import numpy as np
    import torch
    from repro_torch.core import cheby
    from repro_torch.kernels import _build
    from repro_torch.kernels import modified_charges as mcm
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
    lib = _build.load("modified_charges", mcm._SIGNATURES)
    for dtype in (torch.float32, torch.float64):
        rtol, atol = (3e-3, 3e-4) if dtype == torch.float32 else (1e-10, 1e-12)
        for degree in (1, 4, 8, 14):
            tile = lib.mc_tile(dtype.itemsize, degree + 1)
            args = ranged_case(rng, dtype, degree, dev, tile)
            before = mcm.LAUNCHES
            got = ops.modified_charges_ranged(*args, degree=degree,
                                              backend="cuda")
            assert mcm.LAUNCHES == before + 2, "two launches a call"
            again = ops.modified_charges_ranged(*args, degree=degree,
                                                backend="cuda")
            assert torch.equal(got, again), "not bitwise deterministic"
            want = ops.modified_charges_ranged(*args, degree=degree,
                                               backend="torch")
            assert (got[0] == 0).all() and (got[9] == 0).all(), "empty node"
            worst[dtype] = max(worst[dtype], close(
                got, want, rtol, atol,
                f"modified_charges ranged {dtype} degree={degree}",
                scale="max"))
            n += 1
    torch.cuda.synchronize()
    print(f"[3] modified_charges vs plain: {n} cases ok (dense and ranged); "
          f"max abs err f32 {worst[torch.float32]:.3e} (rtol 3e-3 atol 3e-4"
          f"; ranged: times max|q_hat|), f64 {worst[torch.float64]:.3e} "
          f"(rtol 1e-10, atol 1e-12 max|q_hat|)", flush=True)
    # nodes flat in 1, 2 and 3 dimensions (lo == hi there: every particle
    # hits all n+1 coincident nodes, whose count is the denominator)
    n, worst, sum_err = 0, {torch.float32: 0.0, torch.float64: 0.0}, 0.0
    for dtype in (torch.float32, torch.float64):
        rtol, atol = (3e-3, 3e-4) if dtype == torch.float32 else (1e-10, 1e-12)
        for degree in (1, 4, 8, 14):
            for flat in FLAT_DIMS:
                *args, charges = flat_node_case(rng, dtype, degree, flat, dev)
                got = ops.modified_charges_ranged(*args, degree=degree,
                                                  backend="cuda")
                want = ops.modified_charges_ranged(*args, degree=degree,
                                                   backend="torch")
                worst[dtype] = max(worst[dtype], close(
                    got, want, rtol, atol, f"modified_charges flat {flat} "
                    f"{dtype} degree={degree}", scale="max"))
                scale = args[1].abs().sum().item()
                e = (got.sum(1) - charges).abs().max().item() / scale
                tol = 1e-4 if dtype == torch.float32 else 1e-11
                assert e <= tol, (f"flat {flat} {dtype} degree={degree}: "
                                  f"q_hat sums off the node charges by {e}")
                sum_err = max(sum_err, e)
                n += 1
    torch.cuda.synchronize()
    print(f"[3] modified_charges on flat nodes (flat in {FLAT_DIMS}, counts "
          f"1, 37, 300, {mcm.CHUNK + 3} and their parent): {n} cases ok "
          f"against the plain version, max abs err f32 "
          f"{worst[torch.float32]:.3e}, f64 {worst[torch.float64]:.3e} (the "
          f"tolerances above, times max|q_hat|); each node's q_hat sums to "
          f"its charge within {sum_err:.3e} of sum|q| (bars 1e-4 f32, 1e-11 "
          f"f64)", flush=True)
    print_systems_axis("[3]", "modified_charges", dev)


#: A node's flat dimensions in phase 3's flat cases: a sheet, a line, a
#: point (the tests' `tests/test_torch_flat_nodes.py` cases).
FLAT_DIMS = ((2,), (1, 2), (0, 1, 2))


def flat_node_case(rng, dtype, degree, flat, dev):
    """Nodes whose particles share their coordinates in the dimensions
    `flat` (all on one plane, line or point there, so their parent, the
    last node, is flat too): counts 1, 37, 300 and past a chunk, some
    particles ON a Chebyshev node in the other dimensions. Returns the
    arguments of `ops.modified_charges_ranged` and each node's charge."""
    import numpy as np
    import torch
    from repro_torch.core import cheby
    from repro_torch.kernels import modified_charges as mcm

    def dev_t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    counts = [1, 37, 300, mcm.CHUNK + 3]
    plane = dev_t(rng.uniform(-1, 1, 3))
    parts = []
    for c in counts:
        x = dev_t(rng.uniform(-1, 0, 3)) + dev_t(rng.uniform(0, 1, (c, 3)))
        for d in flat:
            x[:, d] = plane[d]
        grid = cheby.cluster_grid(x.amin(0, keepdim=True),
                                  x.amax(0, keepdim=True), degree)[0]
        k = min(c // 3, grid.shape[0])
        x[:k] = grid[:k]                          # exact hits
        parts.append(x)
    pts = torch.cat(parts)
    n = pts.shape[0]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    bounds = [(int(b), int(b) + c) for b, c in zip(start, counts)] + [(0, n)]
    lo = torch.stack([pts[b:e].amin(0) for b, e in bounds])
    hi = torch.stack([pts[b:e].amax(0) for b, e in bounds])
    assert all(bool((lo[:, d] == hi[:, d]).all()) for d in flat)
    q = dev_t(rng.uniform(-1, 1, n))
    chunks, ptr = mcm.chunk_table(np.append(start, 0), counts + [n])
    charges = torch.stack([q[b:e].sum() for b, e in bounds])
    return (pts, q, torch.as_tensor(chunks, device=dev),
            torch.as_tensor(ptr, device=dev), lo, hi, charges)


def print_systems_axis(tag, kind, dev):
    import torch
    n, err = systems_axis_cases(dev, kind)
    torch.cuda.synchronize()
    print(f"{tag} systems axis (W={SYSTEMS_W}: ragged per-system counts, "
          f"per-system kappas, a dummy slot, scratch batch rows; f32 and "
          f"f64, free and periodic): {n} cases ok against the plain "
          f"version (the tolerances above), max abs err {err:.3e}; one "
          f"launch per call, each system bitwise its own single-system "
          f"launch, dummy slots and scratch rows exactly 0", flush=True)


def ranged_case(rng, dtype, degree, dev, tile):
    """Ragged node ranges for the ranged modified charges: counts 0 and 1,
    at the kernel's `tile` and at the chunk size, each node's points in
    its own box with some ON its Chebyshev nodes (exact hits), and a
    last node spanning all the others, as a parent level does. Returns
    the arguments of `ops.modified_charges_ranged`."""
    import numpy as np
    import torch
    from repro_torch.core import cheby
    from repro_torch.kernels import modified_charges as mcm

    def dev_t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    p = mcm.CHUNK
    counts = [0, 1, tile - 1, tile, tile + 1, p - 1, p, p + 1, 3 * p + 5,
              0, 37]
    lo = dev_t(rng.uniform(-1, 0, (len(counts), 3)))
    hi = lo + dev_t(rng.uniform(0.3, 1, (len(counts), 3)))
    grids = cheby.cluster_grid(lo, hi, degree)
    parts = []
    for i, c in enumerate(counts):
        x = lo[i] + (hi[i] - lo[i]) * dev_t(rng.uniform(0, 1, (c, 3)))
        k = min(c // 3, grids.shape[1])
        x[:k] = grids[i, :k]                     # exact hits
        parts.append(x)
    pts = torch.cat(parts)
    n = pts.shape[0]
    start = np.append(np.concatenate([[0], np.cumsum(counts)[:-1]]), 0)
    lo = torch.cat([lo, pts.amin(0, keepdim=True)])
    hi = torch.cat([hi, pts.amax(0, keepdim=True)])
    chunks, ptr = mcm.chunk_table(start, counts + [n])
    return (pts, dev_t(rng.uniform(-1, 1, n)),
            torch.as_tensor(chunks, device=dev),
            torch.as_tensor(ptr, device=dev), lo, hi)


def ptxas_usage(log):
    """{kernel symbol: (registers, spill store bytes, spill load bytes)}
    from an `nvcc -Xptxas -v` report."""
    import re
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def grid_flops(pairs, n1):
    """Operations of the grid field kernel's factored sweep over `pairs`
    (target, grid point) pairs of degree n1 - 1 (GRID_FLOPS_PER_PAIR)."""
    sweeps = pairs / n1 ** 3                 # (target, cluster) sweeps
    return pairs * GRID_FLOPS_PER_PAIR + sweeps * (
        4 * n1 ** 2 + 2 * n1 + 2 * 3 * n1)


def print_grid_usage(usage):
    """The grid field kernel's ptxas report: its f32 n+1 = 9
    instantiations (the main path's Coulomb and Yukawa), then a summary of
    all of them."""
    import re
    for name, (regs, st, ld) in sorted(usage.items()):
        if "grid_field_kernelIfLi9E" in name:
            kid = int(re.search(r"Li9ELi(\d)E", name).group(1))
            print(f"    batch_cluster_field_grid f32 n+1=9 "
                  f"{('coulomb', 'yukawa')[kid]}: {regs} registers, spill "
                  f"stores {st} bytes, spill loads {ld} bytes", flush=True)
    if usage:
        spills = sorted(k for k, v in usage.items() if v[1] or v[2])
        print(f"    batch_cluster_field_grid: {len(usage)} kernels, "
              f"{min(v[0] for v in usage.values())}-"
              f"{max(v[0] for v in usage.values())} registers, "
              f"{len(spills)} spill: "
              + ", ".join(re.sub(r".*grid_field_kernelI(\w+?)EEv.*", r"\1", k)
                          for k in spills), flush=True)


def bc_bound(plan, idx, m_of_cluster, dtype_bytes, src_bytes, sm_mhz,
             flops_per_pair=FLOPS_PER_PAIR, outputs=1, flops=None,
             rows=None):
    """The bound of one batch-cluster (or field) launch, {"ms", "side",
    "pairs", "sides"}: the pairs the data needs (real targets x real
    sources of every valid slot), and the largest ("side") of three
    times ("sides", in ms): the operations over
    PEAK_FP32 (`flops_per_pair` a pair, or `flops(pairs)`), the MUFU
    operations over the SFU rate at `sm_mhz` (None: MAX_SM_MHZ), and the
    bytes over PEAK_BYTES (the lists, the targets, `src_bytes` of
    sources and `outputs` values written per target slot). side is
    "FLOP", "SFU" or "bytes". The rows are the plan's batch rows, or
    `rows` = (real targets per row (R,), the slab's slots a row) for a
    launch with the roles swapped (the transposed pass: clusters' grids
    or leaves as rows, the batches as sources)."""
    import torch
    a = plan.arrays
    if rows is None:
        nt = a["tgt_mask"].sum(1).to(torch.float64)       # (B,)
        b, nb = a["tgt_batched"].shape[:2]
    else:
        nt = rows[0].to(torch.float64)
        b, nb = nt.shape[0], rows[1]
    valid = idx >= 0
    mc = m_of_cluster[idx.clamp(min=0).long()].to(torch.float64)
    pairs = float((nt[:, None] * mc * valid).sum())
    nbytes = (idx.numel() * 4 + b * nb * 3 * dtype_bytes + src_bytes
              + b * nb * outputs * dtype_bytes)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_flops = flops(pairs) if flops else pairs * flops_per_pair
    times = {"FLOP": n_flops / PEAK_FP32,
             "SFU": pairs * MUFU_PER_PAIR / (
                 SFU_PER_SM_CLOCK * sms * (sm_mhz or MAX_SM_MHZ) * 1e6),
             "bytes": nbytes / PEAK_BYTES}
    side = max(times, key=times.get)
    return {"ms": times[side] * 1e3, "side": side, "pairs": pairs,
            "sides": {k: v * 1e3 for k, v in times.items()}}


def bound_text(bd, smi):
    """A bound as printed: its time, side and the three sides' times."""
    return (f"bound {bd['ms']:.3f} ms by {bd['side']} (FLOP "
            f"{bd['sides']['FLOP']:.3f}, SFU {bd['sides']['SFU']:.3f}, "
            f"bytes {bd['sides']['bytes']:.3f} ms; {smi})")


def bound_by(sides):
    """The report's "bound_by" of a kernel whose lanes are bound by
    `sides` (`bc_bound`'s): "bytes" only if every lane is."""
    return "bytes" if all(v == "bytes" for v in sides) else "operations"


def mc_bound(plan, degree, dtype_bytes):
    """(bound_ms, side) of one execute's modified charges (an ensemble's
    over all its members): per real particle of every cluster 3 rows of
    n+1 terms (sub, div, add), the
    denominator and q~ (2 mul, 1 div), t3*q~ (n+1 mul), t1 x t2 once
    ((n+1)^2 mul), then one FMA (2 operations) per (n+1)^3 output; bytes:
    xyz + q per real particle, the nodes and q_hat."""
    members = plan.members if hasattr(plan, "members") else [plan.inner]
    trees = [m.tree for m in members]
    n1 = degree + 1
    particles = float(sum(t.count.sum() for t in trees))   # over all nodes
    nodes = sum(t.num_nodes for t in trees)
    flops = particles * (9 * n1 + 3 + n1 + n1 ** 2 + 2 * n1 ** 3)
    nbytes = (particles * 4 * dtype_bytes
              + nodes * (3 * n1 + n1 ** 3) * dtype_bytes)
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    side = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, side


def mct_bound(plan, degree, dtype_bytes):
    """(bound_ms, side) of one transposed modified-charge call (the
    `mc_bound` twin): per real particle of every cluster the three rows
    (sub, div, add per term), the denominator (2 mul), the contraction
    in factored form ((n+1)^3 + (n+1)^2 + (n+1) FMAs, 2 operations each)
    and the division by the denominator; bytes: xyz per real particle of
    every cluster, the nodes and q_hat's cotangent, and qbar written once
    per particle."""
    tree = plan.inner.tree
    n1 = degree + 1
    particles = float(tree.count.sum())                    # over all nodes
    flops = particles * (9 * n1 + 3 + 2 * (n1 ** 3 + n1 ** 2 + n1))
    nbytes = ((particles * 3 + plan.num_sources) * dtype_bytes
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
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    n = MAIN_N
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
          f"{tuple(a['direct_idx'].shape)}, modified-charge chunks "
          f"{a['mc_chunks'].shape[0]} of at most {mcm.CHUNK} particles",
          flush=True)

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
    assert launches["modified_charges"] == 2 * calls, launches
    READINGS["[4] execute_ms"] = warm_ms
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
    mc_args = (a["src_sorted"], inp.q_sorted, a["mc_chunks"],
               a["mc_chunk_ptr"], a["node_lo"], a["node_hi"])
    qhat = ops.modified_charges_ranged(*mc_args, degree=degree,
                                       backend="cuda")
    qhat_plain = ops.modified_charges_ranged(*mc_args, degree=degree,
                                             backend="torch")
    # q_hat sums bounded Lagrange terms: no entry is an outlier, so atol
    # follows max|q_hat|
    mc_err = close(qhat, qhat_plain, 3e-3, 3e-4,
                   "modified_charges on every node", scale="max")
    assert torch.equal(qhat, ev.compute_qhat_direct(
        a, inp.q_sorted, degree=degree, backend="cuda")), "not deterministic"
    kern = solver.kernel
    # f32 rounding in q_hat against an f64 q_hat of the same inputs, and
    # the error of execute's potential with that q_hat (rounded to f32)
    # in the approximation lane: how much of the error q_hat's sums hold
    qhat64 = ops.modified_charges_ranged(
        *(t.double() for t in mc_args[:2]), *mc_args[2:4],
        *(t.double() for t in mc_args[4:]), degree=degree, backend="torch")
    top = qhat64.abs().max().item()

    def approx_lane(qh):
        return ops.batch_cluster_eval(
            a["approx_idx"], a["tgt_batched"], inp.grids, qh, kernel=kern,
            backend="cuda", tgt_count=inp.tgt_count).reshape(-1)

    swap = approx_lane(qhat64.float()) - approx_lane(qhat)
    err64 = rel2((phi + swap[a["gather_index"]])[sample].double(), ref)
    dev64 = [(t.double() - qhat64).abs().max().item() / top
             for t in (qhat, qhat_plain)]
    print(f"[4] on the real plan: modified_charges on all {qhat.shape[0]} "
          f"nodes max abs err {mc_err:.3e} (rtol 3e-3, atol 3e-4 max|q_hat| "
          f"= {3e-4 * top:.3e}), two calls bitwise equal; against an f64 "
          f"q_hat, max abs err / max|q_hat| {dev64[0]:.3e} (kernel), "
          f"{dev64[1]:.3e} (plain f32); execute's error with the f64 q_hat "
          f"in the approximation lane {err64:.3e} (with the kernel's "
          f"{err:.3e})", flush=True)
    lanes = {"approx": (a["approx_idx"], inp.grids, qhat),
             "direct": (a["direct_idx"], inp.leaf_pts, inp.leaf_q)}
    tgt = a["tgt_batched"]
    b = tgt.shape[0]
    rows = torch.arange(0, b, max(1, b // 32), device=dev)
    # the counts execute passes: target counts on both lanes, leaf
    # particle counts on the direct lane (every grid point is real)
    counts = {"approx": {"tgt_count": inp.tgt_count},
              "direct": {"tgt_count": inp.tgt_count,
                         "src_count": inp.leaf_count}}
    bc_err = 0.0
    for lane, (idx, pts, qq) in lanes.items():
        sub_idx, sub_tgt = idx[rows], tgt[rows]
        sub_kw = dict(counts[lane], tgt_count=inp.tgt_count[rows])
        got = ops.batch_cluster_eval(sub_idx, sub_tgt, pts, qq, kernel=kern,
                                     backend="cuda", **sub_kw)
        want = ops.batch_cluster_eval(sub_idx, sub_tgt, pts, qq, kernel=kern,
                                      backend="torch", **sub_kw)
        real = a["tgt_mask"][rows]
        assert (got[~real] == 0).all(), f"{lane}: padded target slots"
        got, want = got[real], want[real]
        # near pairs make a few |phi| large (1/r at the smallest
        # separations), so atol follows the typical value, median|phi|
        # of the real target slots
        err = close(got, want, 2e-4, 2e-4, f"batch_cluster {lane} lane rows",
                    scale="median")
        bc_err = max(bc_err, err)
        mag = want.abs()
        print(f"[4] batch_cluster {lane} lane on {rows.numel()} batch rows: "
              f"max abs err {err:.3e}; |phi| max {mag.max().item():.4e}, "
              f"median {mag.median().item():.4e}, rms "
              f"{mag.square().mean().sqrt().item():.4e} over {got.numel()} "
              f"real target slots (rtol 2e-4, atol 2e-4 median|phi|)",
              flush=True)
    print(f"[4] max|phi| {phi.abs().max().item():.4e}", flush=True)

    mc_ms = event_ms(lambda: ops.modified_charges_ranged(
        *mc_args, degree=degree, backend="cuda"), 20)
    mc_plain_ms = event_ms(lambda: ops.modified_charges_ranged(
        *mc_args, degree=degree, backend="torch"), 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lane_ms, lane_plain_ms, lane_bound, lane_clock = {}, {}, {}, {}
    leaf_counts = (a["leaf_gather"] >= 0).sum(1)
    n1c = torch.full((a["node_lo"].shape[0],), (degree + 1) ** 3,
                     device=dev)
    for lane, (idx, pts, qq) in lanes.items():
        sampler = smi_sampler()
        try:
            lane_ms[lane] = event_ms(lambda: ops.batch_cluster_eval(
                idx, tgt, pts, qq, kernel=kern, backend="cuda",
                **counts[lane]), 5)
        finally:
            lane_clock[lane] = smi_samples(sampler)
        lane_plain_ms[lane] = event_ms(lambda: ops.batch_cluster_eval(
            idx, tgt, pts, qq, kernel=kern, backend="torch",
            **counts[lane]), 1)
        lane_bound[lane] = bc_bound(
            plan, idx, leaf_counts if lane == "direct" else n1c, 4,
            pts.shape[0] * pts.shape[1] * 4 * 4,
            lane_clock[lane] and lane_clock[lane][0])
    bc_bound_ms = sum(v["ms"] for v in lane_bound.values())
    bc_side = bound_by(v["side"] for v in lane_bound.values())
    mc_bound_ms, mc_side = mc_bound(plan, degree, 4)
    for lane, (idx, pts, _) in lanes.items():
        pairs = lane_bound[lane]["pairs"]
        nb, m = tgt.shape[1], pts.shape[1]
        geo = bcm.swept_pairs(idx, nb, m, **counts[lane])
        full = bcm.swept_pairs(idx, nb, m)
        clock = "no nvidia-smi samples"
        if lane_clock[lane] is not None:
            mhz, watts, k = lane_clock[lane]
            # lane-issue slots the SMs had per swept pair at that clock
            slots = lane_ms[lane] * 1e-3 * mhz * 1e6 * sms * 128
            clock = (f"SM clock {mhz:.0f} MHz, power {watts:.1f} W (median "
                     f"of {k} samples): {slots / geo['pairs']:.2f} issue "
                     f"slots per swept pair")
        print(f"[4] batch_cluster {lane} lane: {lane_ms[lane]:.3f} ms "
              f"(plain {lane_plain_ms[lane]:.1f} ms), {pairs:.4e} pairs "
              f"needed, {bound_text(lane_bound[lane], smi)}; launch "
              f"geometry sweeps {geo['pairs']:.4e} pairs "
              f"({geo['pairs'] / pairs:.3f}x needed; without counts "
              f"{full['pairs']:.4e}), {geo['tiles']} of "
              f"{geo['tiles_launched']} tiles hold a target; {clock}",
              flush=True)
    sizes = (a["mc_chunks"][:, 2] - a["mc_chunks"][:, 1]).double()
    tile = _build.load("modified_charges", mcm._SIGNATURES).mc_tile(
        4, degree + 1)
    needed = float(plan.inner.tree.count.sum())
    swept = sizes.sum().item()
    tile_slots = ((sizes / tile).ceil() * tile).sum().item()
    padded = float(sum(g.numel() for g in a["bucket_gather"]))
    regs = [v for k, v in ptxas_usage(
        _build.BUILD_LOG.get("modified_charges", "")).items()
        if "mc_chunk_kernelIfLi9E" in k]
    clock = "no nvidia-smi samples"
    if lane_clock["direct"] is not None:
        mhz = lane_clock["direct"][0]
        # warp-instruction issue slots (4 schedulers per SM) per
        # particle-level at the clock sampled during the direct lane
        slots = mc_ms * 1e-3 * mhz * 1e6 * sms * 4 / needed
        clock = (f"{slots:.1f} warp-issue slots per particle-level at "
                 f"{mhz:.0f} MHz")
    print(f"[4] modified_charges: {mc_ms:.3f} ms (plain {mc_plain_ms:.1f} "
          f"ms), bound {mc_bound_ms:.4f} ms by {mc_side} ({smi}); "
          f"{launches['modified_charges']} launches over {calls} executes; "
          f"{a['mc_chunks'].shape[0]} chunks = blocks of the chunk kernel "
          f"({tile}-particle tiles); particle-levels needed {needed:.6g}, "
          f"swept {swept:.6g}, tile slots {tile_slots:.6g} (the per-level "
          f"power-of-two buckets hold {padded:.6g}); f32 n+1=9 kernel "
          f"(registers, spill store bytes, spill load bytes) "
          f"{regs[0] if regs else 'not in the build log'}; {clock}",
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


def field_lane(lane):
    """(entry point, plain version) of a lane of the force sweep
    (`eval._LANE_OPS["field"]`): the grid field kernel on the
    approximation lane (clusters as Chebyshev nodes and q_hat), the
    generic field kernel on the direct lane (leaf particles)."""
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops
    if lane == "approx":
        return ops.batch_cluster_field_grid, bcm.batch_cluster_field_grid_plain
    return ops.batch_cluster_field, bcm.batch_cluster_field_plain


#: 4f holds the field kernels to their plain versions, and phi to
#: `execute`, on the first FORCE_ROWS of Fig. 4's 500 batch rows: the
#: magnitude sweep that sets the per-entry bars costs as much as the plain
#: version (~95 s over every row on an H100), which is still timed over
#: the whole lanes.
FORCE_ROWS = 128


def phase_forces(dev, plan, x, q, smi):
    """Fig. 4 forces at 10^6 on the main phase's plan: the two field
    lanes' times against their bounds (the approximation lane's beside
    the generic field kernel's on the same clusters as explicit grid
    points), phi against `execute`, forces against an f64 direct sum on
    sampled targets, and each field kernel against its plain version
    (timed over its whole lane) on the first FORCE_ROWS batch rows.
    Returns the two field kernels' report entries (their launches are
    the MD run's)."""
    import numpy as np
    import torch
    from repro_torch.core import cheby
    from repro_torch.core.direct import direct_field
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops

    a = plan.arrays
    kern = plan.kernel
    bcm.FIELD_LAUNCHES = bcm.GRID_FIELD_LAUNCHES = 0
    phi, force = plan.potential_and_forces(q)
    torch.cuda.synchronize()
    launches = (bcm.FIELD_LAUNCHES, bcm.GRID_FIELD_LAUNCHES)
    assert launches == (1, 1), launches
    pf_ms = event_ms(lambda: plan.potential_and_forces(q), 3)
    n = x.shape[0]
    rng = np.random.default_rng(2021)
    sample = torch.as_tensor(rng.choice(n, 1000, replace=False), device=dev)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
    q64 = q.double()
    _, grad = direct_field(x64[sample], x64, q64, kernel=kern,
                           source_chunk=1 << 14)
    ref = -q64[sample, None] * grad
    assert force.shape == (n, 3) and torch.isfinite(force).all()
    ferr = rel2(force[sample].double(), ref)
    assert ferr <= FORCE_BAR, ferr

    degree = plan.config.degree
    n1 = degree + 1
    lanes = plan_lanes(plan, q)
    tgt = a["tgt_batched"]
    nb = tgt.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    leaf_counts = (a["leaf_gather"] >= 0).sum(1)
    n1c = torch.full((a["node_lo"].shape[0],), n1 ** 3, device=dev)
    real = a["tgt_mask"]
    report, phi_mag = [], 0.0
    for lane, (idx, src, qq, cnt) in lanes.items():
        op, plain = field_lane(lane)

        def run(backend):
            return op(idx, tgt, src, qq, kernel=kern, backend=backend, **cnt)
        got = run("cuda")
        sampler = smi_sampler()
        try:        # 10 calls: long enough for a few clock samples
            ms = event_ms(lambda: run("cuda"), 10)
        finally:
            clock = smi_samples(sampler)
        t0 = time.perf_counter()
        want = run("torch")[:FORCE_ROWS]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        first = dict(cnt, tgt_count=cnt["tgt_count"][:FORCE_ROWS])
        mag = plain(idx[:FORCE_ROWS], tgt[:FORCE_ROWS], src, qq, kernel=kern,
                    magnitude=True, **first)
        phi_mag = phi_mag + mag[..., 0]
        e, r, atol = field_rows_close(got[:FORCE_ROWS], want, mag,
                                      real[:FORCE_ROWS], f"field {lane} lane")
        mhz = clock and clock[0]
        if lane == "approx":
            bd = bc_bound(plan, idx, n1c, 4, (src.numel() + qq.numel()) * 4,
                          mhz, outputs=4, flops=lambda p: grid_flops(p, n1))
            geo = bcm.swept_pairs(idx, nb, n1 ** 3, cnt["tgt_count"],
                                  tile=bcm.grid_tile(4, n1), unroll=1)
        else:
            bd = bc_bound(plan, idx, leaf_counts, 4, src.shape[0]
                          * src.shape[1] * 4 * 4, mhz,
                          FIELD_FLOPS_PER_PAIR, 4)
            geo = bcm.swept_pairs(idx, nb, src.shape[1], **cnt)
        slots = "no nvidia-smi samples"
        if clock is not None:
            # lane-issue slots the SMs had per swept pair at that clock
            issue = ms * 1e-3 * clock[0] * 1e6 * sms * 128
            slots = (f"SM clock {clock[0]:.0f} MHz, power {clock[1]:.1f} W "
                     f"(median of {clock[2]} samples): "
                     f"{issue / geo['pairs']:.2f} issue slots per swept pair")
        print(f"[4f] field {lane} lane ({op.__name__}): {ms:.3f} ms (plain "
              f"{plain_ms:.1f} ms, host clock, one call), {bd['pairs']:.4e}"
              f" pairs needed, {bound_text(bd, smi)}; launch geometry sweeps"
              f" {geo['pairs']:.4e} pairs ({geo['pairs'] / bd['pairs']:.3f}x"
              f" needed); {slots}; against the plain version on the first "
              f"{FORCE_ROWS} of {int(real.any(1).sum())} batch rows: max abs "
              f"err {e:.3e}, "
              f"gradient max err / sum|terms| {r:.3e} ({FIELD_ROWS_RULE}; "
              f"gradient atol {atol})", flush=True)
        if lane == "approx":
            # the same-run yardstick: the generic field kernel on the same
            # clusters as explicit grid points, timed in turns with the
            # grid kernel (grid, generic, generic, grid)
            grids = cheby.cluster_grid(a["node_lo"], a["node_hi"], degree)

            def generic():
                return ops.batch_cluster_field(idx, tgt, grids, qq,
                                               kernel=kern, backend="cuda",
                                               **cnt)
            ge, _, _ = field_rows_close(generic()[:FORCE_ROWS], want, mag,
                                        real[:FORCE_ROWS],
                                        "generic field kernel on the grids")
            turns = [event_ms(f, 5) for f in (lambda: run("cuda"), generic,
                                              generic, lambda: run("cuda"))]
            grid_ms = (turns[0] + turns[3]) / 2
            gen_ms = (turns[1] + turns[2]) / 2
            print(f"[4f] approximation lane, in turns (grid, generic, "
                  f"generic, grid; median of 5 each): grid field kernel "
                  f"{grid_ms:.3f} ms, generic field kernel on the same "
                  f"clusters as {tuple(grids.shape)} points {gen_ms:.3f} ms:"
                  f" {gen_ms / grid_ms:.2f}x; the generic kernel against "
                  f"the grid plain version max abs err {ge:.3e}", flush=True)
        report.append(dict(
            name=("batch_cluster_field_grid" if lane == "approx"
                  else "batch_cluster_field"), route="cuda",
            source=("src/repro_torch/kernels/csrc/batch_cluster_field"
                    + ("_grid.cu" if lane == "approx" else ".cu")),
            replaces="src/repro/core/eval.py:442 (XLA JVP forces path; "
                     "no TPU kernel)",
            launches=0, max_abs_err=e, ms=ms, plain_ms=plain_ms,
            bound_ms=bd["ms"], bound_by=bound_by([bd["side"]]),
            library_ms=None))
    exec_phi = plan.execute(q)
    first = a["gather_index"] < FORCE_ROWS * nb     # targets in those rows
    phi_err, phi_ratio = phi_close(
        phi[first], exec_phi[first],
        phi_mag.flatten(0, 1)[a["gather_index"][first]],
        "potential_and_forces phi vs execute")
    # the bitwise-era rule, which the grid kernel's sum order retired
    old_tol = FIELD_PHI_TOL[4]
    outside = int(((phi - exec_phi).abs() > old_tol[1]
                   * exec_phi.abs().median() + old_tol[0]
                   * exec_phi.abs()).sum())
    print(f"[4f] potential_and_forces at Fig. 4, N={n}: {pf_ms:.3f} ms warm "
          f"median of 3 (CUDA events), {launches[0]} field and "
          f"{launches[1]} grid field launch a call; phi vs execute on the "
          f"{int(first.sum())} targets of the first {FORCE_ROWS} batch rows: "
          f"max abs err {phi_err:.3e}, max err / sum|G q| {phi_ratio:.3e} (bar "
          f"PHI_K {PHI_K[4]} sum|G q| per entry; {outside} entries outside "
          f"FIELD_PHI_TOL's rtol/atol {old_tol} median|phi|, the potential "
          f"kernel's order); forces vs f64 direct sum "
          f"on 1000 sampled targets: relative 2-norm error {ferr:.3e} (bar "
          f"{FORCE_BAR})", flush=True)
    return report


#: How `field_rows_close` holds the field kernel on a plan's batch rows.
FIELD_ROWS_RULE = (f"phi rtol/atol 2e-4 median|phi|, gradient atol "
                   f"{GRAD_K[4]} sum|terms| per entry")


def field_rows_close(got, want, mag, real, what):
    """The field kernel against its plain version on a plan's batch rows
    (`real` the real target slots): padded slots exactly 0, phi with
    atol relative to median|phi| (near pairs make a few |phi| large),
    each gradient entry with `grad_close`. Returns (max abs err, the
    gradient's max err / sum|terms|, the gradient atols' median and max
    as text)."""
    assert (got[~real] == 0).all(), f"{what}: padded target slots"
    got, want, mag = got[real], want[real], mag[real]
    err, ratio = field_close(got, want, mag, 2e-4, 2e-4, what,
                             phi_scale="median")
    atol = GRAD_K[got.element_size()] * mag[:, 1:]
    return err, ratio, (f"median {atol.median().item():.3e}, max "
                        f"{atol.max().item():.3e}")


SHEET_N = 200_000


def phase_sheet(dev, smi):
    """Phase 4's Fig. 4 setting on a sheet: SHEET_N points uniform in
    [-1,1]^2 at z = 0 (a flat plate), charges uniform in [-1,1], uncut.
    Every node is flat in z, so all n+1 Chebyshev nodes of z coincide and
    each particle hits them all. `execute` within 1e-5 and forces within
    FORCE_BAR of an f64 direct sum on 1000 sampled targets, through the
    host-built and the device-built plan and the hierarchical precompute
    (host build); the modified-charge kernel against its plain version on
    every node. (`tools/mc_parent_check.py` runs the kernel as it was
    before the repair on this sheet.)"""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.core.direct import direct_field, direct_sum
    from repro_torch.kernels import ops

    n = SHEET_N
    cfg = fig4_config()
    rng = np.random.default_rng(2022)
    x = np.zeros((n, 3), np.float32)
    x[:, :2] = rng.uniform(-1, 1, (n, 2))
    q = torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32), device=dev)
    sample = torch.as_tensor(rng.choice(n, 1000, replace=False), device=dev)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
    out, ref, fref = [], None, None
    for build, pre in (("host", "direct"), ("device", "direct"),
                       ("host", "hierarchical")):
        solver = TreecodeSolver(dc.replace(cfg, build_backend=build,
                                           precompute=pre))
        plan = solver.plan(x)
        a = plan.arrays
        phi = plan.execute(q)
        ms = event_ms(lambda: plan.execute(q), 5)
        phi_f, force = plan.potential_and_forces(q)
        if ref is None:
            ref = direct_sum(x64[sample], x64, q.double(),
                             kernel=solver.kernel, source_chunk=1 << 15)
            _, grad = direct_field(x64[sample], x64, q.double(),
                                   kernel=solver.kernel, source_chunk=1 << 14)
            fref = -q.double()[sample, None] * grad
        err, ferr = rel2(phi[sample].double(), ref), rel2(
            force[sample].double(), fref)
        assert torch.isfinite(phi).all() and torch.isfinite(force).all()
        assert err <= 1e-5, (build, pre, err)
        assert ferr <= FORCE_BAR, (build, pre, ferr)
        approx = a["approx_idx"]
        swept = torch.unique(approx[approx >= 0])
        lo, hi = a["node_lo"], a["node_hi"]
        flat = (lo == hi).sum(1)                      # flat dimensions
        assert swept.numel() > 0 and bool((flat[swept] >= 1).all())
        inp = ev.kernel_inputs(a, q, degree=cfg.degree)
        mc_args = (a["src_sorted"], inp.q_sorted, a["mc_chunks"],
                   a["mc_chunk_ptr"], lo, hi)
        mc_err = close(ops.modified_charges_ranged(
            *mc_args, degree=cfg.degree, backend="cuda"),
            ops.modified_charges_ranged(
                *mc_args, degree=cfg.degree, backend="torch"), 3e-3, 3e-4,
            f"[4s] {build}: modified_charges on every node", scale="max")
        torch.cuda.synchronize()
        out.append(f"{build} build, {pre} precompute: execute {ms:.3f} ms "
                   f"(median of 5), phi error {err:.3e} (bar 1e-5), forces "
                   f"{ferr:.3e} (bar {FORCE_BAR}); {swept.numel()} "
                   f"approximation-lane nodes of {lo.shape[0]}, flat in "
                   f"{int(flat[swept].min())}-{int(flat[swept].max())} "
                   f"dimensions; modified_charges vs plain max abs err "
                   f"{mc_err:.3e}")
        del plan, phi, phi_f, force
    print(f"[4s] sheet N={n} at z = 0, theta {cfg.theta}, degree "
          f"{cfg.degree}, N_L = N_B = {cfg.leaf_size} ({smi}): "
          + "; ".join(out), flush=True)


def plan_lanes(plan, q):
    """The field kernels' two lanes on `plan` for charges `q`, as its
    force evaluation gives them (`eval.lane_inputs`: the modified
    charges from the CUDA kernel, the skin routing of the current
    geometry, the approximation lane's clusters as Chebyshev nodes)."""
    from repro_torch.core import eval as ev
    c = plan.config
    return ev.lane_inputs(plan.arrays, q, degree=c.degree, space=c.space,
                          backend="cuda", theta=c.theta, skin=c.skin,
                          grid_nodes=True, precompute=c.precompute)


def plan_field_rows(plan, q, what, rows=64):
    """The field kernels against their plain versions on the first `rows`
    batch rows of both lanes of `plan` (an MD's current capacity-padded,
    refitted plan, or a device-built one), on the inputs its force
    evaluation gives them for charges `q` (the grid field kernel on the
    approximation lane, the field kernel on the direct lane). Returns the
    max abs error; the launches here are not counted."""
    import torch
    tgt = plan.arrays["tgt_batched"][:rows]
    real = plan.arrays["tgt_mask"][:rows]
    opts = dict(kernel=plan.kernel, space=plan.config.space,
                kahan=plan.config.kahan)
    err, ratio, out = 0.0, 0.0, []
    for lane, (idx, pts, qq, cnt) in plan_lanes(plan, q).items():
        cnt = dict(cnt, tgt_count=cnt["tgt_count"][:rows])
        args = (idx[:rows], tgt, pts, qq)
        op, plain = field_lane(lane)
        got = op(*args, backend="cuda", **opts, **cnt)
        want = op(*args, backend="torch", **opts, **cnt)
        mag = plain(*args, magnitude=True, **opts, **cnt)
        e, r, atol = field_rows_close(got, want, mag, real,
                                      f"{what}: field {lane} lane rows")
        err, ratio = max(err, e), max(ratio, r)
        out.append(f"{lane} {tuple(idx.shape)} slots x {tuple(pts.shape)} "
                   f"sources, max abs err {e:.3e}, gradient atol {atol}")
    torch.cuda.synchronize()
    print(f"    {what}: field kernels vs plain on the first {rows} batch rows "
          f"of the padded plan ({FIELD_ROWS_RULE}): " + "; ".join(out)
          + f"; gradient max err / sum|terms| {ratio:.3e}", flush=True)
    return err


def energy_balance(sim, phi0, v0):
    """(dKE, dPE) from the state where phi0 and v0 were read to the
    current one, in f64: dPE = 1/2 sum_i q_i (phi_i - phi0_i), from the
    per-particle differences, so the f32 rounding of the energy's sum
    (about 1e-6 of it at 10^6 particles) drops out. Velocity Verlet
    conserves dKE + dPE to rounding; forces of the wrong sign or size
    break it by the order of dKE."""
    m = sim.masses.double()
    m = m[:, None] if m.dim() else m
    v, v0 = sim.state.v.double(), v0.double()
    dke = 0.5 * (m * (v * v - v0 * v0)).sum()
    dpe = 0.5 * (sim.charges.double()
                 * (sim.state.phi.double() - phi0.double())).sum()
    return dke.item(), dpe.item()


#: Readings of this run that phase 15 prints beside earlier PRs'.
READINGS = {}


def guarded(fn, *args, out=False):
    """`fn(*args)` under `lint.runtime.no_implicit_syncs()` (the card's
    set_sync_debug_mode("error")) with the mode "warn" outside it: an
    implicit sync raises, and each explicit pull both counts in
    `sync_counts()` and warns as the ad hoc switch of earlier PRs did.
    Returns (explicit pulls by reason, synchronizing warnings), and with
    ``out`` also fn's result."""
    import warnings
    import torch
    from repro_torch.lint import runtime as rt

    before = rt.sync_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with rt.no_implicit_syncs():
                res = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    after = rt.sync_counts()
    pulls = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    warned = sum("called a synchronizing CUDA operation" in str(w.message)
                 for w in caught)
    return ((pulls, warned), res) if out else (pulls, warned)


def salt_lattice(m, lo, spacing, seed):
    """m^3 alternating +-1 charges on a cubic lattice jittered by
    MD_JITTER of the spacing (zero net charge for even m)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    x = lo + spacing * (g + 0.5 + MD_JITTER * rng.standard_normal(g.shape))
    q = np.where(g.sum(1) % 2 == 0, 1.0, -1.0)
    return x.astype(np.float32), q.astype(np.float32)


#: The host rebuild step of the MD at 10^6 in run 6 of PR 15 (NVIDIA H100
#: 80GB HBM3, 700.00 W; PERF.md section 5), printed beside the device's.
PR15_HOST_REBUILD_MS = 1501.3


def phase_md(dev, tag="[8]", build_backend="host", async_replan=False,
             host_ref=None):
    """`Simulation` at N = 10^6 and the Fig. 4 settings: a jittered 100^3
    lattice in [-1,1]^3, velocity Verlet, MD_STEPS steps, refit interval
    MD_REFIT, rebuilding on the host or (``build_backend="device"``) on
    the card, synchronously or double-buffered (`async_replan`). Steps
    2.. run with every launch counter at 0 before them; each refit step
    (a shadow dispatch included) must make exactly one host sync; no
    capacity growth and no kernel build after step 1. Prints the
    window's total, the refit steps that dispatch a shadow build apart
    from the others, and (`host_ref`: the host-rebuild run's median
    rebuild step and total) the host's numbers beside the device's.
    Every step 2.. runs under `lint.runtime.no_implicit_syncs()` with the
    mode "warn" outside it, so a refit step's explicit pulls are counted
    both ways: by `sync_counts()` and by the debug mode's warnings.
    Returns the launches of each kernel in that run, the median rebuild
    step, the window's total (ms) and the simulation."""
    import torch
    from repro_torch.configs.bltc import fig4
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.dynamics import Simulation
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.obs import events, trace

    x, q = salt_lattice(MD_M, -1.0, 2.0 / MD_M, 31)
    n = x.shape[0]
    assert q.sum() == 0
    t0 = time.perf_counter()
    cfg = dataclasses.replace(fig4(theta=0.7, degree=8), skin=MD_SKIN,
                              build_backend=build_backend)
    plan = TreecodeSolver(cfg).plan(x, capacities="auto")
    sim = Simulation(plan, q, dt=MD_DT, refit_interval=MD_REFIT,
                     async_replan=async_replan)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    sim.log.record(0, sim.diagnostics())
    phi0, v0 = sim.state.phi.clone(), sim.state.v.clone()
    sim.step()
    torch.cuda.synchronize()
    builds0 = events.build_count()
    bcm.LAUNCHES = bcm.FIELD_LAUNCHES = bcm.GRID_FIELD_LAUNCHES = 0
    mcm.LAUNCHES = 0
    step_ms = {"refit": [], "dispatch": [], "rebuild": []}
    syncs, explicit, dispatch_ms, wait_ms = [], [], [], []
    for _ in range(MD_STEPS - 1):
        refits0, pending0 = sim.refits, sim._pending
        swaps0, wait0 = sim.plan_swaps, sim.rebuild_wait_ms
        t0 = time.perf_counter()
        pulls, caught = guarded(sim.step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kind = "refit" if sim.refits > refits0 else "rebuild"
        if kind == "refit":
            syncs.append(caught)
            explicit.append(pulls)
        if pending0 is None and sim._pending is not None:
            dispatch_ms.append(sim._pending_dispatch_ms)
            kind = "dispatch"
        step_ms[kind].append(ms)
        if sim.plan_swaps > swaps0:
            wait_ms.append(sim.rebuild_wait_ms - wait0)
    launches = {"batch_cluster_field": bcm.FIELD_LAUNCHES,
                "batch_cluster_field_grid": bcm.GRID_FIELD_LAUNCHES,
                "modified_charges": mcm.LAUNCHES,
                "batch_cluster": bcm.LAUNCHES}
    steps = MD_STEPS - 1
    assert launches["batch_cluster_field"] == steps, launches
    assert launches["batch_cluster_field_grid"] == steps, launches
    assert launches["modified_charges"] == 2 * steps, launches
    sim.log.record(sim.steps, sim.diagnostics())
    st = sim.stats()
    builds = events.build_count() - builds0
    assert st["capacity_growths"] == 0 and st["retraces"] == 0, st
    assert builds == 0, builds
    assert syncs and all(k == 1 for k in syncs), syncs
    assert all(e == {"drift": 1} for e in explicit), explicit
    assert st["rebuilds"] >= 1, st
    if build_backend == "device":
        assert st["devtree_rebuilds"] == st["rebuilds"], st
    if async_replan:
        assert st["plan_swaps"] == st["rebuilds"] and dispatch_ms, st
    assert torch.isfinite(sim.state.x).all() and torch.isfinite(
        sim.state.f).all()
    drift, mom = sim.log.drift(), sim.log.momentum_drift()
    assert drift < 1e-3, drift
    rows_err = plan_field_rows(sim.plan, sim.charges, tag)
    dke, dpe = energy_balance(sim, phi0, v0)
    balance = abs(dke + dpe) / dke
    assert dke > 0 and balance <= ENERGY_BAR, (dke, dpe)
    # span breakdown of two more refit steps, traced (tracing syncs
    # inside each span)
    trace.clear()
    trace.enable()
    try:
        for _ in range(2):
            sim.step()
    finally:
        trace.disable()
    spans = {k: v / 2 for k, v in trace.phase_totals("md.").items()}
    med = {k: (statistics.median(v) if v else float("nan"))
           for k, v in step_ms.items()}
    window_ms = sum(sum(v) for v in step_ms.values())
    how = {"host": "host rebuilds",
           "device": "device rebuilds" + (", async_replan" if async_replan
                                          else "")}[build_backend]
    print(f"{tag} MD at Fig. 4, N={n} (jittered {MD_M}^3 lattice, +-1 "
          f"charges), {how}, skin {MD_SKIN}, velocity Verlet, dt {MD_DT}, "
          f"refit interval {MD_REFIT}: setup {setup_ms:.0f} ms; steps "
          f"2-{MD_STEPS}: "
          f"{window_ms:.1f} ms in all; {len(step_ms['refit'])} refit steps "
          f"(no dispatch), median {med['refit']:.2f} ms, "
          f"{len(step_ms['dispatch'])} refit steps that dispatch a shadow "
          f"build, ms {[round(v, 2) for v in step_ms['dispatch']]}, "
          f"{len(step_ms['rebuild'])} rebuild steps, median "
          f"{med['rebuild']:.1f} ms (host clock to a synchronize); "
          f"refits {st['refits']}, rebuilds {st['rebuilds']} (drift "
          f"{st['rebuilds_drift']}, interval {st['rebuilds_interval']}, "
          f"forced {st['rebuilds_forced']}; on the device "
          f"{st['devtree_rebuilds']}); relative energy drift "
          f"{drift:.3e} (f32 sums), momentum drift {mom:.3e}; over steps "
          f"0-{MD_STEPS} in f64 dKE {dke:.6e}, dPE {dpe:.6e}, |dKE + dPE| "
          f"/ dKE {balance:.3e} (bar {ENERGY_BAR}); field kernel vs plain "
          f"on the MD plan's rows max abs err {rows_err:.3e}; "
          f"capacity growths "
          f"{st['capacity_growths']}, retraces {st['retraces']}, kernel "
          f"builds after step 1 {builds}; host syncs per refit step "
          f"{sorted(set(syncs))} (warnings of set_sync_debug_mode('warn')), "
          f"beside explicit_sync per refit step "
          f"{sorted(set(map(str, explicit)))} under no_implicit_syncs() "
          f"(steps 2-{MD_STEPS} all guarded); launches over steps "
          f"2-{MD_STEPS} {launches}", flush=True)
    if build_backend == "device":
        ref = ("" if host_ref is None else
               f", {host_ref[0]:.1f} ms in this run's host-rebuild "
               f"MD, whose steps 2-{MD_STEPS} took {host_ref[1]:.1f} "
               f"ms in all")
        print(f"{tag} rebuild step {med['rebuild']:.1f} ms on the device "
              f"against {PR15_HOST_REBUILD_MS} ms on the host (run 6 of PR "
              f"15{ref}); rebuild wall time in all {st['rebuild_total_ms']:.1f}"
              f" ms, blocked {st['rebuild_wait_ms']:.1f} ms"
              + (f"; shadow dispatch ms {[round(v, 2) for v in dispatch_ms]}"
                 f", wait ms at commit {[round(v, 2) for v in wait_ms]}"
                 if async_replan else ""), flush=True)
    print(f"{tag} traced refit step, ms per step by span: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(spans.items())), flush=True)
    READINGS[f"{tag} refit_ms"] = med["refit"]
    return launches, med["rebuild"], window_ms, sim


def phase_md_periodic(dev):
    """A periodic Yukawa MD with a Verlet skin: the skin gate and
    minimum-image forces through refits and a rebuild; at the final
    positions an f64 plan's forces and the MD's f32 forces against an f64
    minimum-image direct sum."""
    import numpy as np
    import torch
    from repro_torch.core.api import TreecodeConfig, TreecodeSolver
    from repro_torch.core.direct import direct_field
    from repro_torch.core.space import PeriodicBox
    from repro_torch.dynamics import Simulation

    x, q = salt_lattice(PMD_M, 0.0, PMD_L / PMD_M, 32)
    n = x.shape[0]
    box = PeriodicBox((PMD_L,) * 3)
    cfg = TreecodeConfig(theta=0.7, degree=8, leaf_size=2000, space=box,
                         skin=0.02, kernel="yukawa",
                         kernel_params={"kappa": PMD_KAPPA})
    sim = Simulation(TreecodeSolver(cfg).plan(box.wrap(x)), q, dt=PMD_DT,
                     refit_interval=MD_REFIT, profile=True)
    phi0, v0 = sim.state.phi.clone(), sim.state.v.clone()
    t0 = time.perf_counter()
    sim.run(MD_STEPS, record_every=MD_STEPS // 2)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    st = sim.stats()
    assert st["refits"] >= 1 and st["retraces"] == 0, st
    drift = sim.log.drift()
    assert drift < 1e-3, drift
    plan_field_rows(sim.plan, sim.charges, "[9]")
    dke, dpe = energy_balance(sim, phi0, v0)
    balance = abs(dke + dpe) / dke
    assert dke > 0 and balance <= ENERGY_BAR, (dke, dpe)
    _, force = sim.plan.potential_and_forces(q)
    # the approximation at the final positions, in f64: a fresh plan
    x_fin = box.wrap(sim.state.x.double())
    plan64 = TreecodeSolver(dataclasses.replace(cfg, dtype="float64")).plan(
        x_fin)
    q64 = torch.as_tensor(q, dtype=torch.float64, device=dev)
    _, force64 = plan64.potential_and_forces(q64)
    rng = np.random.default_rng(33)
    sample = torch.as_tensor(rng.choice(n, 500, replace=False), device=dev)
    _, grad = direct_field(x_fin[sample], x_fin, q64, kernel=plan64.kernel,
                           space=box, source_chunk=1 << 14)
    ref = -q64[sample, None] * grad
    err64 = rel2(force64[sample], ref)
    err32 = rel2(force[sample].double(), ref)
    assert err64 <= FORCE_BAR, err64
    assert err32 <= F32_CANCEL_BAR, err32
    occ = st.get("occupancy", {})
    print(f"[9] periodic Yukawa MD (kappa {PMD_KAPPA}, box {PMD_L}, skin "
          f"0.02, N={n}): {MD_STEPS} steps in {run_ms:.0f} ms; refits "
          f"{st['refits']}, rebuilds {st['rebuilds']} (drift "
          f"{st['rebuilds_drift']}, interval {st['rebuilds_interval']}); "
          f"relative energy drift {drift:.3e} (f32 sums); in f64 dKE "
          f"{dke:.6e}, dPE {dpe:.6e}, |dKE + dPE| / dKE {balance:.3e} (bar "
          f"{ENERGY_BAR}); skin pairs "
          f"{occ.get('skin_pairs', float('nan')):.0f}, accept rate "
          f"{occ.get('skin_accept_rate', float('nan')):.3f}; at the final "
          f"positions, forces vs an f64 minimum-image direct sum on 500 "
          f"targets, relative 2-norm: f64 plan {err64:.3e} (bar "
          f"{FORCE_BAR}), the MD's f32 forces {err32:.3e} (bar "
          f"{F32_CANCEL_BAR}, f32 cancellation)", flush=True)


def plan_potential_rows(plan, q, what, rows=64):
    """batch_cluster against its plain version on the first `rows` batch
    rows of both lanes of `plan`, on the tensors `execute` feeds it for
    charges `q` (`eval.lane_inputs`): padded target slots exactly 0, phi
    at rtol 2e-4 and atol 2e-4 median|phi|, q_hat from the plan's own
    precompute. Returns the max abs error; these launches are not
    counted."""
    import torch
    from repro_torch.core import eval as ev
    from repro_torch.kernels import ops
    c, a = plan.config, plan.arrays
    tgt, real = a["tgt_batched"][:rows], a["tgt_mask"][:rows]
    err = 0.0
    lanes = ev.lane_inputs(a, q, degree=c.degree, space=c.space,
                           backend="cuda", theta=c.theta, skin=c.skin,
                           precompute=c.precompute)
    for lane, (idx, pts, qq, cnt) in lanes.items():
        cnt = dict(cnt, tgt_count=cnt["tgt_count"][:rows])
        got, want = (ops.batch_cluster_eval(
            idx[:rows], tgt, pts, qq, kernel=plan.kernel, space=c.space,
            backend=b, **cnt) for b in ("cuda", "torch"))
        assert (got[~real] == 0).all(), f"{what}: {lane} padded slots"
        err = max(err, close(got[real], want[real], 2e-4, 2e-4,
                             f"{what}: batch_cluster {lane} lane rows",
                             scale="median"))
    torch.cuda.synchronize()
    return err


def coverage(plan):
    """How often each source (tree order) is covered in each real batch
    row of `plan` by the row's approximated clusters and direct leaves:
    (real rows, N) int32, from +1/-1 marks at every range's ends and a
    cumsum (integer scatters: exact)."""
    import torch
    from repro_torch.core import eval as ev
    a = plan.arrays
    dev = a["src_sorted"].device
    host = {"node_lo": a["node_lo"].cpu().numpy(),
            "bucket_gather": tuple(g.cpu().numpy()
                                   for g in a["bucket_gather"]),
            "bucket_nodes": tuple(g.cpu().numpy()
                                  for g in a["bucket_nodes"])}
    start, count = (torch.as_tensor(v, device=dev)
                    for v in ev.node_ranges(host))
    lg = a["leaf_gather"]
    n = a["src_sorted"].shape[0]
    b = a["tgt_batched"].shape[0]
    marks = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    for idx, st, ct in ((a["approx_idx"], start, count),
                        (a["direct_idx"], lg[:, 0].clamp(min=0),
                         (lg >= 0).sum(1))):
        i = idx.clamp(min=0).long()
        row = torch.arange(b, device=dev)[:, None].expand_as(i)
        one = (idx >= 0).to(torch.int32)
        s0 = st[i].long()
        marks.index_put_((row, s0), one, accumulate=True)
        marks.index_put_((row, s0 + ct[i].long()), -one, accumulate=True)
    return marks.cumsum(1, dtype=torch.int32)[:, :n][a["tgt_mask"].any(1)]


def phase_device_plan(dev, smi, x, q):
    """The device-built plan (`build_backend="device"`) at the Fig. 4
    setting on the main phase's 10^6 points and charges: cold build and
    a warm budgeted replan by phase; `execute` and `potential_and_forces`
    against an f64 direct sum on 1000 sampled targets (1e-5, FORCE_BAR)
    with every kernel's launch counter from 0; the four kernels against
    their plain versions on the plan's first 64 batch rows (the modified
    charges on every node); a replan that is deterministic and keeps its
    shapes; `replan_async` dispatched under
    torch.cuda.set_sync_debug_mode("error"); and at 10^5 every (target,
    source) pair covered exactly once by the device plan's lists, as by
    the host plan's."""
    import numpy as np
    import torch
    from repro_torch.configs.bltc import fig4
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.core.direct import direct_field, direct_sum
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(fig4(theta=0.7, degree=8),
                              build_backend="device")
    solver = TreecodeSolver(cfg)
    xd = torch.as_tensor(x, device=dev)
    n = x.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = solver.plan(xd)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    cold = {k: round(v, 2) for k, v in plan.inner.build_ms.items()}
    plan.replan(xd)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2 = plan.replan(xd)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm = {k: round(v, 2) for k, v in p2.inner.build_ms.items()}
    assert ev.plan_signature(p2.inner) == ev.plan_signature(plan.inner)
    for k, v in plan.arrays.items():
        if not isinstance(v, tuple):
            assert torch.equal(v, p2.arrays[k]), f"replan not bitwise: {k}"
    st = plan.stats()
    assert plan.inner.tree._obj is None, "stats built the host tree"
    a = plan.arrays
    print(f"[10] device plan at Fig. 4, N={n}: cold build {cold_ms:.1f} ms "
          f"{cold}; warm budgeted replan {warm_ms:.2f} ms by phase {warm} "
          f"(host clock to a synchronize; bitwise equal to the first, same "
          f"shapes); octree depth {st['tree_depth']}, {st['num_nodes']} "
          f"node rows, leaves {st['num_leaves']}, batches "
          f"{st['num_batches']}; approx {tuple(a['approx_idx'].shape)}, "
          f"direct {tuple(a['direct_idx'].shape)}, chunks "
          f"{a['mc_chunks'].shape[0]}; padding waste "
          f"{st['padding_waste']:.3f}", flush=True)

    # the path, every launch counted from 0
    bcm.LAUNCHES = bcm.FIELD_LAUNCHES = bcm.GRID_FIELD_LAUNCHES = 0
    mcm.LAUNCHES = 0
    phi = plan.execute(q)
    _, force = plan.potential_and_forces(q)
    torch.cuda.synchronize()
    launches = {"batch_cluster": bcm.LAUNCHES,
                "modified_charges": mcm.LAUNCHES,
                "batch_cluster_field": bcm.FIELD_LAUNCHES,
                "batch_cluster_field_grid": bcm.GRID_FIELD_LAUNCHES}
    assert launches["batch_cluster"] >= 2 and launches == dict(
        launches, modified_charges=4, batch_cluster_field=1,
        batch_cluster_field_grid=1), launches
    exec_ms = event_ms(lambda: plan.execute(q), 5)
    pf_ms = event_ms(lambda: plan.potential_and_forces(q), 3)
    rng = np.random.default_rng(2023)
    sample = torch.as_tensor(rng.choice(n, 1000, replace=False), device=dev)
    x64 = xd.double()
    q64 = q.double()
    ref = direct_sum(x64[sample], x64, q64, kernel=solver.kernel,
                     source_chunk=1 << 15)
    _, grad = direct_field(x64[sample], x64, q64, kernel=solver.kernel,
                           source_chunk=1 << 14)
    err = rel2(phi[sample].double(), ref)
    ferr = rel2(force[sample].double(), -q64[sample, None] * grad)
    assert torch.isfinite(phi).all() and err <= 1e-5, err
    assert torch.isfinite(force).all() and ferr <= FORCE_BAR, ferr

    bc_err = plan_potential_rows(plan, q, "[10]")
    field_err = plan_field_rows(plan, q, "[10]")
    inp = ev.kernel_inputs(a, q, degree=cfg.degree, grids=False)
    mc_args = (a["src_sorted"], inp.q_sorted, a["mc_chunks"],
               a["mc_chunk_ptr"], a["node_lo"], a["node_hi"])
    mc_err = close(
        ops.modified_charges_ranged(*mc_args, degree=cfg.degree,
                                    backend="cuda"),
        ops.modified_charges_ranged(*mc_args, degree=cfg.degree,
                                    backend="torch"),
        3e-3, 3e-4, "[10] modified_charges on every node", scale="max")
    print(f"[10] execute {exec_ms:.3f} ms, potential_and_forces {pf_ms:.3f} "
          f"ms (warm medians, CUDA events); launches of one execute and one "
          f"potential_and_forces {launches}; vs f64 direct sum on 1000 "
          f"sampled targets: phi rel 2-norm {err:.3e} (bar 1e-5), forces "
          f"{ferr:.3e} (bar {FORCE_BAR}); kernels vs plain: batch_cluster "
          f"on the first 64 batch rows max abs err {bc_err:.3e}, field "
          f"kernels {field_err:.3e}, modified_charges on all "
          f"{a['node_lo'].shape[0]} node rows {mc_err:.3e} (rtol 3e-3, "
          f"atol 3e-4 max|q_hat|)", flush=True)

    # the double-buffered replan: no host sync until finalize
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (pulls, caught), pending = guarded(plan.replan_async, xd, out=True)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    assert pulls == {} and caught == 0, (pulls, caught)
    p3, wait_ms, grew = pending.finalize()
    assert not grew
    for k, v in plan.arrays.items():
        if not isinstance(v, tuple):
            assert torch.equal(v, p3.arrays[k]), f"async replan: {k}"
    assert torch.equal(p3.execute(q), phi)
    print(f"[10] replan_async under no_implicit_syncs() "
          f"(set_sync_debug_mode('error')): dispatch {dispatch_ms:.2f} ms "
          f"(host), explicit pulls {pulls}, debug-mode warnings {caught}; "
          f"finalize waited {wait_ms:.2f} ms; the swapped plan is bitwise "
          f"the synchronous one", flush=True)

    # pair coverage at 10^5 on both builds
    x5 = torch.as_tensor(np.random.default_rng(2024).uniform(
        -1, 1, (100_000, 3)).astype(np.float32), device=dev)
    covered = {}
    for backend in ("host", "device"):
        p5 = TreecodeSolver(dataclasses.replace(
            cfg, build_backend=backend)).plan(x5)
        cov = coverage(p5)
        assert (cov == 1).all(), (backend, int((cov != 1).sum()))
        covered[backend] = (cov.shape[0], int(
            (p5.arrays["direct_idx"] >= 0).sum()))
    print(f"[10] pair coverage at N=100000: every (target, source) pair "
          f"covered exactly once on both builds (real batch rows, direct "
          f"leaf slots): host {covered['host']}, device "
          f"{covered['device']}", flush=True)
    return plan


def phase_hierarchical(dev, x, q, mc_ms):
    """The hierarchical precompute at the Fig. 4 setting: q_hat against
    the direct precompute in f64 on 10^5 points (rtol 1e-10, atol 1e-12
    max|q_hat|; positive charges), two calls bitwise equal; `execute` at
    10^6 on the main phase's points against an f64 direct sum (1e-5),
    with the modified-charge kernel's launches counted from 0; on that
    plan's own inputs the modified-charge kernel over the leaf chunk
    table and batch_cluster on the first 64 batch rows (with the
    hierarchical q_hat) against their plain versions; the precompute's
    time beside the direct one's."""
    import numpy as np
    import torch
    from repro_torch.configs.bltc import fig4
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.core.direct import direct_sum
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(fig4(theta=0.7, degree=8),
                              precompute="hierarchical")
    degree = cfg.degree
    r = np.random.default_rng(2025)
    x5, q5 = r.uniform(-1, 1, (100_000, 3)), r.uniform(0.5, 1.5, 100_000)
    p5 = TreecodeSolver(dataclasses.replace(cfg, dtype="float64")).plan(x5)
    a5 = p5.arrays
    qs = torch.as_tensor(q5, device=dev)[a5["src_perm"]]
    mcm.LAUNCHES = 0
    hier = ev.compute_qhat_hierarchical(a5, qs, degree=degree,
                                        backend="cuda")
    assert mcm.LAUNCHES == 2, mcm.LAUNCHES
    assert torch.equal(hier, ev.compute_qhat_hierarchical(
        a5, qs, degree=degree, backend="cuda")), "not deterministic"
    direct = ev.compute_qhat_direct(a5, qs, degree=degree, backend="cuda")
    e5 = close(hier, direct, 1e-10, 1e-12, "[11] hierarchical q_hat f64",
               scale="max")

    n = x.shape[0]
    t0 = time.perf_counter()
    plan = TreecodeSolver(cfg).plan(x)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    a = plan.arrays
    bcm.LAUNCHES = 0
    mcm.LAUNCHES = 0
    phi = plan.execute(q)
    torch.cuda.synchronize()
    launches = {"batch_cluster": bcm.LAUNCHES,
                "modified_charges": mcm.LAUNCHES}
    assert launches["modified_charges"] == 2, launches
    assert launches["batch_cluster"] >= 2, launches
    exec_ms = event_ms(lambda: plan.execute(q), 5)
    qsorted = q[a["src_perm"]]
    leaf_args = (a["src_sorted"], qsorted, a["mc_leaf_chunks"],
                 a["mc_leaf_chunk_ptr"], a["node_lo"], a["node_hi"])
    leaf_err = close(
        ops.modified_charges_ranged(*leaf_args, degree=degree,
                                    backend="cuda"),
        ops.modified_charges_ranged(*leaf_args, degree=degree,
                                    backend="torch"),
        3e-3, 3e-4, "[11] modified_charges on the leaf chunk table",
        scale="max")
    bc_err = plan_potential_rows(plan, q, "[11]")
    sample = torch.as_tensor(np.random.default_rng(2026).choice(
        n, 1000, replace=False), device=dev)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
    ref = direct_sum(x64[sample], x64, q.double(), kernel=plan.kernel,
                     source_chunk=1 << 15)
    err = rel2(phi[sample].double(), ref)
    assert torch.isfinite(phi).all() and err <= 1e-5, err
    pre = {name: event_ms(lambda: fn(a, qsorted, degree=degree,
                                     backend="cuda"), 10)
           for name, fn in (("hierarchical", ev.compute_qhat_hierarchical),
                            ("direct", ev.compute_qhat_direct))}
    print(f"[11] hierarchical precompute: q_hat vs direct in f64 at N=100000"
          f" max abs err {e5:.3e} (rtol 1e-10, atol 1e-12 max|q_hat|), two "
          f"calls bitwise equal; at Fig. 4, N={n}: host plan "
          f"{plan_ms:.0f} ms, {len(a['upward_pairs'])} upward levels "
          f"{[int(p.shape[0]) for p in a['upward_pairs']]} pairs, "
          f"{a['mc_leaf_chunks'].shape[0]} leaf chunks; execute "
          f"{exec_ms:.3f} ms (warm median, CUDA events), launches {launches};"
          f" rel 2-norm error vs f64 direct sum on 1000 targets {err:.3e} "
          f"(bar 1e-5); kernels vs plain on this plan's inputs: "
          f"modified_charges on the leaf chunk table max abs err "
          f"{leaf_err:.3e} (rtol 3e-3, atol 3e-4 max|q_hat|), batch_cluster "
          f"on the first 64 batch rows with the hierarchical q_hat "
          f"{bc_err:.3e}; q_hat {pre['hierarchical']:.3f} ms hierarchical "
          f"(leaves' modified charges + the upward einsums) against "
          f"{pre['direct']:.3f} ms direct (the kernel alone in this run's "
          f"phase 4: {mc_ms:.3f} ms; 0.598 ms in run 6 of PR 15)",
          flush=True)


#: Rows of each transposed lane held against the plain version in phase 14.
DIFF_ROWS = 64
#: Particles of phase 14's f64 case (Fig. 4 statics otherwise).
DIFF_F64_N = 100_000
#: The transposed modified charges against their plain version: each
#: particle's error within MCT_K times its own sum of the terms'
#: magnitudes (the plain version's `magnitude=True` sweep), by itemsize.
MCT_K = {4: 1e-5, 8: 1e-13}


def timed(fn):
    """(fn(), its milliseconds by CUDA events): one run."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def diff_vjp(plan, q, u, targets=True, charges=True, backend=None):
    """(phi, tbar, qbar) of `differentiable_execute` on `plan` (None for a
    cotangent not asked for), the backward's CUDA-event ms, and the
    launch counters' increments over the backward alone."""
    import torch
    from repro_torch.core import eval as ev
    a = dict(plan.arrays)
    tgt = a["tgt_batched"].detach().clone().requires_grad_(targets)
    a["tgt_batched"] = tgt
    qt = q.detach().clone().requires_grad_(charges)
    opts = plan.config.exec_opts(plan.kernel)
    if backend:
        opts["backend"] = backend
    phi = ev.differentiable_execute(a, qt, plan.kernel_params, **opts)
    torch.cuda.synchronize()
    wrt = [t for t, on in ((tgt, targets), (qt, charges)) if on]
    before = launch_counts_all()
    grads, ms = timed(lambda: list(torch.autograd.grad(phi, wrt, u)))
    counts = tuple(b - a for a, b in zip(before, launch_counts_all()))
    tbar = grads.pop(0) if targets else None
    qbar = grads.pop(0) if charges else None
    return (phi.detach(), tbar, qbar), ms, counts


def launch_counts_all():
    """`launch_counts` and the transposed modified charges' launches."""
    from repro_torch.kernels import modified_charges as mcm
    return launch_counts() + (mcm.TRANSPOSE_LAUNCHES,)


def adjoint_gap(u, phi, qbar, q):
    """|<u, phi> - <qbar, q>| / (|u| |phi|), in f64."""
    u, phi, qbar, q = (t.double() for t in (u, phi, qbar, q))
    return abs(float(u @ phi - qbar @ q)) / float(u.norm() * phi.norm())


def phase_differentiable(dev, smi, plan, x, q):
    """Phase 14: the differentiable executor's backward at Fig. 4 on the
    main phase's plan, points and charges, with a seeded cotangent u:
    the forward and the three backwards (charges, targets, both) by CUDA
    events (median of 3), each path's launches from 0; phi bitwise
    `execute`'s, the target cotangent bitwise u g of
    `potential_and_gradient`, the adjoint identity in f32 (1e-5 of
    |u| |phi|); each transposed batch-cluster lane on its first DIFF_ROWS
    rows against the plain version (PHI_K times sum |G u| per entry), the
    transposed modified-charge kernel on the whole plan against its plain
    version (MCT_K times its sum of magnitudes per entry), their times and
    bounds; an f64 plan at DIFF_F64_N: the adjoint identity (1e-12) and
    the CUDA backward against the "torch" backend's (rtol 1e-10, atol
    1e-12 max|want|). Returns the transposed kernel's report entry."""
    import numpy as np
    import torch
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.kernels import _build
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    from repro_torch.kernels import ops

    a, cfg, kern = plan.arrays, plan.config, plan.kernel
    degree, n1 = cfg.degree, cfg.degree + 1
    u = torch.as_tensor(np.random.default_rng(2027).uniform(
        -1, 1, plan.num_targets).astype(np.float32), device=dev)

    # -- the slice's main path: forward and backward, counts from 0 ----
    zero_launch_counts()
    mcm.TRANSPOSE_LAUNCHES = 0
    (phi, tbar, qbar), _, per_back = diff_vjp(plan, q, u)
    path = dict(zip(("batch_cluster", "modified_charges", "field",
                     "grid_field", "modified_charges_transpose"),
                    launch_counts_all()))
    assert all(v > 0 for v in path.values()), path
    assert per_back == (2, 2, 1, 1, 1), per_back
    charge_only = diff_vjp(plan, q, u, targets=False)
    target_only = diff_vjp(plan, q, u, charges=False)
    assert charge_only[2] == (2, 0, 0, 0, 1), charge_only[2]
    assert target_only[2] == (0, 2, 1, 1, 0), target_only[2]

    # -- checks ---------------------------------------------------------
    assert torch.equal(phi, plan.execute(q)), "phi is not execute's"
    _, g = ev.potential_and_gradient(a, q, plan.kernel_params,
                                     **cfg.exec_opts(kern))
    got_t = tbar.reshape(-1, 3)[a["gather_index"]]
    assert torch.equal(got_t, u[:, None] * g), "target cotangent"
    assert (tbar[~a["tgt_mask"]] == 0).all(), "padded target slots"
    gap = adjoint_gap(u, phi, qbar, q)
    assert torch.isfinite(qbar).all() and gap <= 1e-5, gap

    # -- timings (median of 3) ------------------------------------------
    opts = cfg.exec_opts(kern)

    def forward():
        ta = dict(a, tgt_batched=a["tgt_batched"].clone().requires_grad_())
        return ev.differentiable_execute(
            ta, q.clone().requires_grad_(), plan.kernel_params, **opts)

    fwd_ms = event_ms(forward, 3)
    back_ms = {name: statistics.median(
        diff_vjp(plan, q, u, **kw)[1] for _ in range(3))
        for name, kw in (("charges", dict(targets=False)),
                         ("targets", dict(charges=False)),
                         ("both", {}))}
    print(f"[14] differentiable_execute at Fig. 4, N={plan.num_targets} "
          f"(f32 Coulomb; CUDA events, median of 3): forward "
          f"{fwd_ms:.3f} ms; backward charges {back_ms['charges']:.3f} ms, "
          f"targets {back_ms['targets']:.3f} ms, both {back_ms['both']:.3f}"
          f" ms ({smi}); launches (batch_cluster, modified_charges, field, "
          f"grid field, transposed modified charges) of the forward and "
          f"backward {path}, of a backward: both {per_back}, charges "
          f"{charge_only[2]}, targets {target_only[2]}; phi bitwise "
          f"execute's, the target cotangent bitwise u g of "
          f"potential_and_gradient; adjoint identity |<u,phi> - <qbar,q>| "
          f"/ (|u||phi|) = {gap:.3e} (bar 1e-5)", flush=True)

    # -- the transposed lanes against the plain version, on the tensors
    # the backward feeds them (eval.transposed_lane_inputs) -------------
    lo, lg = a["node_lo"], a["leaf_gather"]
    lists = (a["approx_idx"], a["direct_idx"])          # skin 0: unrouted
    t_lists_ms = event_ms(lambda: (
        ev.transposed_lists(lists[0], lo.shape[0]),
        ev.transposed_lists(lists[1], lg.shape[0])), 3)
    lanes = ev.transposed_lane_inputs(a, u, lists, degree=degree)
    kw = dict(kernel=kern, space=cfg.space, kahan=cfg.kahan)
    tgt, nb = a["tgt_batched"], a["tgt_batched"].shape[1]
    lane_ms, bounds, bc_err, ratio, out = {}, {}, 0.0, 0.0, []
    for lane, (rows_t, pts, u_slots, cnt) in lanes.items():
        if lane == "approx":
            cnt = dict(cnt, r2_mode=cfg.approx_r2)
        sub = {k: (v[:DIFF_ROWS] if k == "tgt_count" else v)
               for k, v in cnt.items()}
        args = (rows_t[:DIFF_ROWS], pts[:DIFF_ROWS], tgt)
        got = ops.batch_cluster_eval(*args, u_slots, backend="cuda", **kw,
                                     **sub)
        want = ops.batch_cluster_eval(*args, u_slots, backend="torch", **kw,
                                      **sub)
        mag = ops.batch_cluster_eval(*args, u_slots.abs(), backend="torch",
                                     **kw, **sub)         # G > 0: sum |G u|
        e, rt = phi_close(got, want, mag, f"[14] transposed {lane} lane rows")
        bc_err, ratio = max(bc_err, e), max(ratio, rt)
        lane_ms[lane] = event_ms(lambda: ops.batch_cluster_eval(
            rows_t, pts, tgt, u_slots, backend="cuda", **kw, **cnt), 3)
        real = cnt.get("tgt_count", torch.full(
            (rows_t.shape[0],), n1 ** 3, device=dev))
        bounds[lane] = bc_bound(plan, rows_t, cnt["src_count"], 4,
                                tgt.numel() * 4 * 4 // 3, None,
                                rows=(real, pts.shape[1]))
        geo = bcm.swept_pairs(rows_t, pts.shape[1], nb,
                              tgt_count=cnt.get("tgt_count"),
                              src_count=cnt["src_count"])
        out.append(f"{lane}: S_T {rows_t.shape[1]} ({tuple(rows_t.shape)} "
                   f"slots, {int((rows_t >= 0).sum())} valid), "
                   f"{lane_ms[lane]:.3f} ms, {bounds[lane]['pairs']:.4e} "
                   f"pairs needed, geometry sweeps {geo['pairs']:.4e}, "
                   f"{bound_text(bounds[lane], smi)}")
    print(f"[14] transposed batch_cluster lanes: " + "; ".join(out)
          + f"; against the plain version on the first {DIFF_ROWS} rows of "
          f"each: max abs err {bc_err:.3e}, max err / sum|G u| {ratio:.3e} "
          f"(bar {PHI_K[4]}); both list transposes {t_lists_ms:.3f} ms",
          flush=True)

    # -- the transposed modified charges on the whole plan --------------
    rows_t, grids, u_slots, cnt = lanes["approx"]
    qhat_bar = ops.batch_cluster_eval(rows_t, grids, tgt, u_slots,
                                      backend="cuda", r2_mode=cfg.approx_r2,
                                      **kw, **cnt)
    levels, n_src = len(a["bucket_nodes"]), a["src_sorted"].shape[0]

    def table():
        return mcm.tile_table(a["mc_chunks"], a["parent_of"], levels, n_src)

    tiles, chain = table()
    mct_args = (a["src_sorted"], qhat_bar, tiles, chain, a["node_lo"],
                a["node_hi"])
    got = ops.modified_charges_transpose_ranged(
        *mct_args, degree=degree, backend="cuda")
    assert torch.equal(got, ops.modified_charges_transpose_ranged(
        *mct_args, degree=degree, backend="cuda")), \
        "the transposed modified charges are not deterministic"
    want, mct_plain_ms = timed(lambda: ops.modified_charges_transpose_ranged(
        *mct_args, degree=degree, backend="torch"))
    mag = mcm.modified_charges_transpose_ranged_plain(
        *mct_args, degree, magnitude=True)
    k = MCT_K[4]
    err = (got - want).abs()
    assert torch.isfinite(got).all() and not (err > k * mag).any(), (
        f"[14] transposed modified charges: {int((err > k * mag).sum())} "
        f"entries outside {k} * sum|terms| (max err {err.max().item():.3e})")
    mct_err = err.max().item()
    mct_ratio = (err / mag)[mag > 0].max().item()
    mct_ms = event_ms(lambda: ops.modified_charges_transpose_ranged(
        *mct_args, degree=degree, backend="cuda"), 20)
    mct_bound_ms, mct_side = mct_bound(plan, degree, 4)
    table_ms = event_ms(table, 20)
    kern_args = (*mct_args, degree)
    burst = 20
    _, burst_ms = timed(lambda: [
        mcm.modified_charges_transpose_ranged_cuda(*kern_args)
        for _ in range(burst)])
    span = tiles[:, 1] - tiles[:, 0]
    depth = (chain >= 0).sum(1)
    real = int(((span > 0) & (depth > 0)).sum())
    swept = int((span * depth).sum())

    def mct_kind(name, cat):
        if cat == "gpu_memset":
            return "memset"
        if "mct_tile_kernel" in name:
            return "mct_tile_kernel"
        return "node mapping" if cat == "kernel" else cat

    split = profile_split(lambda: ops.modified_charges_transpose_ranged(
        *mct_args, degree=degree, backend="cuda"), 10, mct_kind)
    table_split = profile_split(
        table, 10, lambda name, cat: "tile table" if cat == "kernel"
        else cat)
    print(f"[14] profiler split of one transposed modified-charge call: "
          f"{split_text(split)}; of the tile table's build: "
          f"{split_text(table_split)}", flush=True)
    regs = [v for key, v in ptxas_usage(
        _build.BUILD_LOG.get("modified_charges", "")).items()
        if "mct_tile_kernelIfLi9E" in key]
    print(f"[14] transposed modified charges over {tiles.shape[0]} tiles "
          f"({real} with particles and nodes; {mcm.TILE} particles at most) "
          f"and {levels} levels, {swept} particle-levels swept: "
          f"{mct_ms:.3f} ms a call (CUDA events, median of 20), the kernel "
          f"alone {burst_ms / burst:.4f} ms a launch ({burst} launches back "
          f"to back), the plain version {mct_plain_ms:.1f} ms, bound "
          f"{mct_bound_ms:.4f} ms by {mct_side} ({smi}); the tile table's "
          f"build (once per plan) {table_ms:.3f} ms; the charge "
          f"backward {back_ms['charges']:.3f} ms; against the plain version "
          f"on all {got.numel()} particles max abs err {mct_err:.3e}, max "
          f"err / sum|terms| {mct_ratio:.3e} (bar {k}); two calls bitwise "
          f"equal; f32 n+1=9 kernel (registers, spill store bytes, spill "
          f"load bytes) {regs[0] if regs else 'not in the build log'}",
          flush=True)

    # -- f64 at DIFF_F64_N: the identity, and CUDA against "torch" --------
    r = np.random.default_rng(2028)
    x5 = r.uniform(-1, 1, (DIFF_F64_N, 3))
    q5, u5 = (torch.as_tensor(r.uniform(-1, 1, DIFF_F64_N), device=dev)
              for _ in range(2))
    p5 = TreecodeSolver(dataclasses.replace(cfg, dtype="float64"),
                        device=dev).plan(x5)
    got5, ms5, _ = diff_vjp(p5, q5, u5)
    want5, plain5_ms, _ = diff_vjp(p5, q5, u5, backend="torch")
    gap5 = adjoint_gap(u5, got5[0], got5[2], q5)
    assert gap5 <= 1e-12, gap5
    mask = p5.arrays["tgt_mask"]
    e5 = [close(g, w, 1e-10, 1e-12, f"[14] f64 {what}", scale="max")
          for what, g, w in (("phi", got5[0], want5[0]),
                             ("target cotangent", got5[1][mask],
                              want5[1][mask]),
                             ("charge cotangent", got5[2], want5[2]))]
    print(f"[14] f64 at N={DIFF_F64_N} (Fig. 4 statics): adjoint identity "
          f"{gap5:.3e} (bar 1e-12); CUDA backward {ms5:.3f} ms against the "
          f"torch backend's {plain5_ms:.1f} ms: max abs err phi {e5[0]:.3e}, "
          f"target cotangent {e5[1]:.3e}, charge cotangent {e5[2]:.3e} "
          f"(rtol 1e-10, atol 1e-12 max|want|)", flush=True)
    return dict(name="modified_charges_transpose", route="cuda",
                source="src/repro_torch/kernels/csrc/modified_charges.cu",
                replaces="src/repro/core/eval.py:496 (jax.vjp of the XLA "
                         "modified charges; no TPU kernel)",
                launches=path["modified_charges_transpose"],
                max_abs_err=mct_err, ms=mct_ms, plain_ms=mct_plain_ms,
                bound_ms=mct_bound_ms, bound_by=mct_side, library_ms=None)


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

    n = PERIODIC_N
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


# Phase 12 (serving) at the Fig. 4 statics: 8 systems of about 7.2*10^5
# points in all for the ensemble, a 5-kappa scan, the service on 24
# requests of 50,000-100,000 points, and an 8-replica MD of 32^3 lattices.
SERVE_SIZES = (131_072, 120_000, 100_000, 90_000, 80_000, 70_000, 66_000,
               60_000)
SERVE_REQUEST_SIZES = (50_000, 60_000, 100_000)
SERVE_KAPPAS = (0.5, 1.0, 2.0)
SERVE_MD_M = 32
SERVE_MD_STEPS = 20


def serve_config(kernel="yukawa"):
    """The Fig. 4 statics (theta 0.7, degree 8, N_L = N_B = 2000, f32)
    with `kernel`."""
    return dataclasses.replace(fig4_config(), kernel=kernel)


def fig4_config():
    from repro_torch.configs.bltc import fig4
    return fig4(theta=0.7, degree=8)


def launch_counts():
    """(batch_cluster, modified_charges, field, grid field) launches."""
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    return (bcm.LAUNCHES, mcm.LAUNCHES, bcm.FIELD_LAUNCHES,
            bcm.GRID_FIELD_LAUNCHES)


def zero_launch_counts():
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import modified_charges as mcm
    bcm.LAUNCHES = mcm.LAUNCHES = 0
    bcm.FIELD_LAUNCHES = bcm.GRID_FIELD_LAUNCHES = 0


def flat_systems(a, idx, m_of_cluster):
    """A stacked lane as one flat single-system lane, for `bc_bound`:
    ({"tgt_mask", "tgt_batched"} (W*B, ...), idx (W*B, S) with system w's
    cluster ids offset by w*C, m_of_cluster (W*C,))."""
    import types
    import torch
    w, c = m_of_cluster.shape
    off = (torch.arange(w, device=idx.device) * c)[:, None, None]
    flat_idx = torch.where(idx >= 0, idx + off, idx).flatten(0, 1)
    view = types.SimpleNamespace(arrays={
        "tgt_mask": a["tgt_mask"].flatten(0, 1),
        "tgt_batched": a["tgt_batched"].flatten(0, 1)})
    return view, flat_idx, m_of_cluster.flatten()


#: How `stacked_rows_check` holds the kernels against their plain versions.
STACKED_ROWS_RULE = (f"phi {PHI_K[4]} sum|G q| and gradient {GRAD_K[4]} "
                     f"sum|terms| per entry, q_hat rtol 3e-3 atol 3e-4 "
                     f"max|q_hat|")


def stacked_rows_check(a, charges, kp, cfg, kernel, what, rows=64):
    """Each kernel against its plain version on stacked plan arrays `a`
    (an ensemble's, refitted or not) for charges (W, ns) and per-system
    parameters `kp`, on the tensors the ensemble executors feed them
    (`eval.lane_inputs` with the config's skin, so skin lists go through
    the stacked MAC gate): batch_cluster on both potential lanes and the
    two field kernels on the force lanes, each on the first `rows` batch
    rows of every system, and the modified charges on every node of every
    system. Padded target slots are exactly 0; each phi entry is held to
    PHI_K times its own sum |G q| and each gradient entry to GRAD_K times
    its sum |terms| (the plain field version's magnitude sweep over the
    same slots), since a lane may leave most targets without a term (the
    inner batches of 12d's small trees approximate no cluster) and
    neutral systems cancel, where a median |phi| scale says nothing.
    Returns {kernel: (max abs err, max err / sum|terms|)}; these
    launches are not counted."""
    import torch
    from repro_torch.core import eval as ev
    from repro_torch.kernels import ops
    lane_kw = dict(degree=cfg.degree, space=cfg.space, backend="cuda",
                   theta=cfg.theta, skin=cfg.skin, precompute=cfg.precompute)
    opts = dict(kernel=kernel.stripped(), space=cfg.space, kahan=cfg.kahan)
    tgt, real = a["tgt_batched"][:, :rows], a["tgt_mask"][:, :rows]
    pot = ev.lane_inputs(a, charges, **lane_kw)
    fld = ev.lane_inputs(a, charges, grid_nodes=True, **lane_kw)
    worst = {}

    def note(key, err, ratio):
        e, r = worst.get(key, (0.0, 0.0))
        worst[key] = (max(e, err), max(r, ratio))

    for lane, (idx, pts, qq, cnt) in pot.items():
        # the rows' lists up to their last real slot (the rest of the
        # stacked width is -1 in every row): the plain versions sweep
        # every slot they are given
        cols = (idx[:, :rows] >= 0).any(0).any(0).nonzero()
        used = int(cols.max()) + 1 if cols.numel() else 1
        kw = dict(opts, **dict(cnt, tgt_count=cnt["tgt_count"][:, :rows]))
        if lane == "approx":
            kw["r2_mode"] = cfg.approx_r2
        got, want = (ops.batch_cluster_eval(
            idx[:, :rows, :used], tgt, pts, qq, kp, backend=b, **kw)
            for b in ("cuda", "torch"))
        op, plain = field_lane(lane)
        fidx, fpts, fqq, fcnt = fld[lane]
        fkw = dict(opts, **dict(fcnt, tgt_count=fcnt["tgt_count"][:, :rows]))
        fargs = (fidx[:, :rows, :used], tgt, fpts, fqq, kp)
        fgot, fwant = (op(*fargs, backend=b, **fkw) for b in ("cuda", "torch"))
        mag = plain(*fargs, magnitude=True, **fkw)[real]
        assert (got[~real] == 0).all(), f"{what}: batch_cluster {lane} pad"
        assert (fgot[~real] == 0).all(), f"{what}: field {lane} padding"
        note("batch_cluster", *phi_close(got[real], want[real], mag[:, 0],
                                         f"{what}: batch_cluster {lane}"))
        fgot, fwant = fgot[real], fwant[real]
        e, r = phi_close(fgot[:, 0], fwant[:, 0], mag[:, 0],
                         f"{what}: field {lane} phi")
        ge, gr = grad_close(fgot[:, 1:], fwant[:, 1:], mag[:, 1:],
                            f"{what}: field {lane}")
        note("field_grid" if lane == "approx" else "field", max(e, ge),
             max(r, gr))
    chunk_keys = (ev.LEAF_CHUNK_KEYS if cfg.precompute == "hierarchical"
                  else ("mc_chunks", "mc_chunk_ptr"))
    inp = ev.kernel_inputs(a, charges, degree=cfg.degree, grids=False)
    mc_args = (a["src_sorted"], inp.q_sorted, *(a[k] for k in chunk_keys),
               a["node_lo"], a["node_hi"])
    qh, qh_plain = (ops.modified_charges_ranged(
        *mc_args, degree=cfg.degree, backend=b) for b in ("cuda", "torch"))
    note("modified_charges", close(qh, qh_plain, 3e-3, 3e-4,
                                   f"{what}: modified_charges",
                                   scale="max"), 0.0)
    torch.cuda.synchronize()
    return {k: f"{e:.3e} ({r:.3e} of sum|terms|)" if r else f"{e:.3e}"
            for k, (e, r) in worst.items()}


def phase_serve_ensemble(dev, smi):
    """12a: an EnsemblePlan over SERVE_SIZES (Yukawa, a kappa per system
    as device tensors): execute and potential_and_forces beside the sum
    of the 8 single-system plans' times, the launches a call, each system
    against an f64 direct sum and against its own single-system plan,
    each lane kernel on the stacked shapes against its bound, and each
    kernel against its plain version on the first 64 batch rows of every
    system."""
    import numpy as np
    import torch
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.core.direct import direct_field, direct_sum
    from repro_torch.core.potentials import yukawa
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops
    from repro_torch.serve import EnsemblePlan

    cfg = serve_config()
    rng = np.random.default_rng(1212)
    xs = [rng.uniform(-1, 1, (n, 3)).astype(np.float32) for n in SERVE_SIZES]
    qs = [torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32),
                          device=dev) for n in SERVE_SIZES]
    W = len(xs)
    kappa = torch.linspace(0.5, 2.0, W, device=dev)
    params = [{"kappa": kappa[i]} for i in range(W)]
    t0 = time.perf_counter()
    plan = EnsemblePlan.build(cfg, xs)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    caps = plan.capacities
    slab = plan._charges(qs)
    kp = plan._params(params)
    opts = cfg.exec_opts(plan.kernel)

    zero_launch_counts()
    phi = plan.execute(slab, kernel_params=params)
    torch.cuda.synchronize()
    ex = launch_counts()
    zero_launch_counts()
    phi2, F = plan.potential_and_forces(slab, kernel_params=params)
    torch.cuda.synchronize()
    pf = launch_counts()
    assert ex == (2, 2, 0, 0), f"execute launches {ex}"
    assert pf == (0, 2, 1, 1), f"potential_and_forces launches {pf}"
    exec_ms = event_ms(lambda: plan.execute(slab, kernel_params=params), 7)
    pf_ms = event_ms(lambda: plan.potential_and_forces(
        slab, kernel_params=params), 7)

    singles, single_exec, single_pf, vs_single = [], [], [], []
    for i, x in enumerate(xs):
        sp = TreecodeSolver(cfg).plan(x)
        kpi = {"kappa": kappa[i]}
        single_exec.append(event_ms(lambda: sp.execute(
            qs[i], kernel_params=kpi), 7))
        single_pf.append(event_ms(lambda: sp.potential_and_forces(
            qs[i], kernel_params=kpi), 7))
        n = len(x)
        ref_phi = sp.execute(qs[i], kernel_params=kpi)
        ref_phi2, ref_F = sp.potential_and_forces(qs[i], kernel_params=kpi)
        vs_single.append(max(rel2(phi[i, :n], ref_phi),
                             rel2(phi2[i, :n], ref_phi2),
                             rel2(F[i, :n], ref_F)))
        assert vs_single[-1] <= 1e-6, (i, vs_single[-1])
        del sp
    errs, ferrs = [], []
    for i, x in enumerate(xs):
        n = len(x)
        sample = torch.as_tensor(rng.choice(n, 1000, replace=False),
                                 device=dev)
        x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
        q64 = qs[i].double()
        kern = yukawa(float(kappa[i]))
        ref = direct_sum(x64[sample], x64, q64, kernel=kern,
                         source_chunk=1 << 15)
        _, grad = direct_field(x64[sample], x64, q64, kernel=kern,
                               source_chunk=1 << 14)
        errs.append(rel2(phi[i, sample].double(), ref))
        ferrs.append(rel2(F[i, sample].double(), -q64[sample, None] * grad))
        assert torch.isfinite(phi[i]).all() and torch.isfinite(F[i]).all()
        assert (phi[i, n:] == 0).all() and (F[i, n:] == 0).all(), i
        assert errs[-1] <= 1e-5, (i, errs[-1])
        assert ferrs[-1] <= FORCE_BAR, (i, ferrs[-1])
    print(f"[12a] EnsemblePlan of {W} systems {SERVE_SIZES} "
          f"({sum(SERVE_SIZES)} points), Yukawa kappa 0.5..2.0 per system "
          f"(device tensors), Fig. 4 statics: host build {build_ms:.1f} ms; "
          f"point budget {caps.num_targets}, batches {caps.num_batches} x "
          f"{caps.batch_width}, nodes {caps.num_nodes}, approx width "
          f"{caps.approx_width}, direct width {caps.direct_width}; launches "
          f"a call (batch_cluster, modified_charges, field, grid field): "
          f"execute {ex}, potential_and_forces {pf}", flush=True)
    print(f"[12a] execute {exec_ms:.3f} ms, potential_and_forces "
          f"{pf_ms:.3f} ms (CUDA events, median of 7); the 8 single-system "
          f"plans in the same run: execute {sum(single_exec):.3f} ms, "
          f"potential_and_forces {sum(single_pf):.3f} ms in all "
          f"(stacked / sum: {exec_ms / sum(single_exec):.3f}, "
          f"{pf_ms / sum(single_pf):.3f}; {smi})", flush=True)
    print(f"[12a] per system vs f64 direct sum on 1000 sampled targets: phi "
          f"rel 2-norm max {max(errs):.3e} (bar 1e-5), forces max "
          f"{max(ferrs):.3e} (bar {FORCE_BAR}); vs its own single-system "
          f"plan (phi, forces) max {max(vs_single):.3e} (bar 1e-6); padded "
          f"slots exactly 0", flush=True)

    # the lanes as the executors feed them, per kernel: stacked times and
    # bounds; then every kernel against its plain version
    a = plan.arrays
    degree, n1 = cfg.degree, cfg.degree + 1
    lane_kw = dict(degree=degree, space=cfg.space, backend="cuda",
                   theta=cfg.theta, skin=cfg.skin)
    pot = ev.lane_inputs(a, slab, **lane_kw)
    fld = ev.lane_inputs(a, slab, grid_nodes=True, **lane_kw)
    kern = plan.kernel.stripped()
    leaf_counts = (a["leaf_gather"] >= 0).sum(-1)
    n1c = torch.full(a["node_lo"].shape[:2], n1 ** 3, device=dev)
    lines = []
    for name, lanes in (("batch_cluster", pot), ("field", fld)):
        for lane, (idx, pts, qq, cnt) in lanes.items():
            op = ops.batch_cluster_eval if name == "batch_cluster" \
                else field_lane(lane)[0]
            ms = event_ms(lambda: op(idx, a["tgt_batched"], pts, qq, kp,
                                     backend="cuda", kernel=kern, **cnt), 5)
            view, fidx, m_of = flat_systems(
                a, idx, leaf_counts if lane == "direct" else n1c)
            if name == "batch_cluster":
                bd = bc_bound(view, fidx, m_of, 4, (pts.numel()
                              + qq.numel()) * 4, None)
            elif lane == "approx":
                bd = bc_bound(view, fidx, m_of, 4, (pts.numel()
                              + qq.numel()) * 4, None, outputs=4,
                              flops=lambda p: grid_flops(p, n1))
            else:
                bd = bc_bound(view, fidx, m_of, 4, (pts.numel()
                              + qq.numel()) * 4, None,
                              FIELD_FLOPS_PER_PAIR, 4)
            lines.append(f"{op.__name__} {lane} {tuple(idx.shape)}: "
                         f"{ms:.3f} ms, {bd['pairs']:.4e} pairs, "
                         f"{bound_text(bd, smi)}")
    inp = ev.kernel_inputs(a, slab, degree=degree, grids=False)
    mc_args = (a["src_sorted"], inp.q_sorted, a["mc_chunks"],
               a["mc_chunk_ptr"], a["node_lo"], a["node_hi"])
    mc_ms = event_ms(lambda: ops.modified_charges_ranged(
        *mc_args, degree=degree, backend="cuda"), 7)
    rows = 64
    worst = stacked_rows_check(a, slab, kp, cfg, plan.kernel, "12a", rows)
    print("[12a] stacked lanes (W = 8, CUDA events, median of 5): "
          + "; ".join(lines), flush=True)
    mc_bound_ms, mc_side = mc_bound(plan, degree, 4)
    print(f"[12a] modified_charges on the stack: {mc_ms:.3f} ms over "
          f"{a['mc_chunks'].shape[0] * a['mc_chunks'].shape[1]} chunk rows, "
          f"bound {mc_bound_ms:.4f} ms by {mc_side} ({smi}); "
          f"each kernel vs its plain version (first {rows} batch rows of "
          f"every system; the modified charges on every node; "
          f"{STACKED_ROWS_RULE}): max abs err {worst}", flush=True)
    assert (bcm.LAUNCHES, bcm.FIELD_LAUNCHES) != (0, 0)


def phase_serve_kappa_scan(dev):
    """12b: five kappas over one geometry (W = 5): the warm call runs
    under torch.cuda.set_sync_debug_mode("error"), with no rebuild; each
    row against a single-system plan of its kappa."""
    import numpy as np
    import torch
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.kernels import _build
    from repro_torch.serve import EnsemblePlan

    cfg = serve_config()
    rng = np.random.default_rng(1213)
    n = SERVE_SIZES[2]
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    q = torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32), device=dev)
    kappas = torch.linspace(0.25, 2.0, 5, device=dev)
    plan = EnsemblePlan.build(cfg, [x] * 5)
    slab = plan._charges([q] * 5)
    params = [{"kappa": kappas[i]} for i in range(5)]
    plan.execute(slab, kernel_params=params)           # warm
    torch.cuda.synchronize()
    libs, built = dict(_build._LIBS), dict(_build.BUILD_SECONDS)
    zero_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        phi = plan.execute(slab, kernel_params=params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = launch_counts()
    assert launched == (2, 2, 0, 0), launched
    assert _build._LIBS == libs and _build.BUILD_SECONDS == built, \
        "a kernel was rebuilt or reloaded"
    single = TreecodeSolver(cfg).plan(x)
    errs = [rel2(phi[i, :n], single.execute(q, kernel_params={
        "kappa": kappas[i]})) for i in range(5)]
    assert max(errs) <= 1e-6, errs
    assert not torch.equal(phi[0], phi[1])
    rows = 16
    worst = stacked_rows_check(plan.arrays, slab, plan._params(params), cfg,
                               plan.kernel, "12b", rows)
    print(f"[12b] kappa scan {[round(float(k), 4) for k in kappas]} over one "
          f"geometry of {n} points (W = 5): the warm call under "
          f"set_sync_debug_mode('error'), no rebuild, launches {launched}; "
          f"each row vs a single-system plan of its kappa max rel 2-norm "
          f"{max(errs):.3e} (bar 1e-6); each kernel vs its plain version "
          f"(first {rows} batch rows of every system; the modified charges "
          f"on every node; {STACKED_ROWS_RULE}): max abs err {worst}",
          flush=True)


def phase_serve_frontend(dev):
    """12c: ServeFrontend(max_batch 8) on 24 requests (sizes cycling
    SERVE_REQUEST_SIZES, kappas SERVE_KAPPAS, forces every third), then
    the same 24 again: latency, occupancy, flushes, buckets and the
    compile counters; resubmission adds no compile, retrace or capacity
    growth; every request against a single-system plan, and each
    bucket's last flush through `stacked_rows_check`."""
    import numpy as np
    import torch
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.serve import ServeFrontend, bucket_key

    cfg = serve_config()
    rng = np.random.default_rng(1214)
    reqs = []
    for i in range(24):
        n = SERVE_REQUEST_SIZES[i % 3]
        reqs.append((rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                     rng.uniform(-1, 1, n).astype(np.float32),
                     {"kappa": SERVE_KAPPAS[i % 3]}, i % 3 == 0))
    fe = ServeFrontend(cfg, max_batch=8)

    def submit_all():
        t0 = time.perf_counter()
        futs = [fe.submit(x, q, kernel_params=p, forces=f)
                for x, q, p, f in reqs]
        fe.flush()
        out = [f.result() for f in futs]
        return out, (time.perf_counter() - t0) * 1e3

    zero_launch_counts()
    first, first_ms = submit_all()
    launched = launch_counts()
    assert all(launched), f"a kernel of the service never ran: {launched}"
    s1 = fe.stats()
    kinds = 2
    assert s1["compiles"] <= s1["num_buckets"] * kinds, s1
    assert s1["retraces"] == 0, s1
    again, again_ms = submit_all()
    s2 = fe.stats()
    warm = {k: s2[k] - s1[k] for k in ("compiles", "retraces",
                                       "capacity_growths", "flushes")}
    assert warm["compiles"] == warm["retraces"] == 0, warm
    assert warm["capacity_growths"] == 0, warm
    # every request (each slot of every flush) against a single-system
    # plan on the first pass; the warm pass bitwise the first
    errs = []
    for i, (x, q, p, forces) in enumerate(reqs):
        sp = TreecodeSolver(dataclasses.replace(cfg, kernel_params=p)).plan(x)
        if forces:
            phi, F = (t.cpu() for t in sp.potential_and_forces(
                torch.as_tensor(q, device=dev)))
            errs += [rel2(first[i][0], phi), rel2(first[i][1], F)]
            assert torch.equal(again[i][0], first[i][0])
            assert torch.equal(again[i][1], first[i][1])
        else:
            phi = sp.execute(torch.as_tensor(q, device=dev)).cpu()
            errs.append(rel2(first[i], phi))
            assert torch.equal(again[i], first[i])
        del sp
    assert max(errs) <= 1e-6, errs
    # each bucket's last flush (the last max_batch requests it took) on
    # its own stacked plan: every kernel against its plain version
    rows, worst = 16, {}
    for key, bucket in fe.buckets.items():
        batch = [r for r in reqs
                 if bucket_key(cfg, r[0].shape[0]) == key][-fe.max_batch:]
        plan = bucket.plan
        kp = plan._params([r[2] for r in batch])
        worst[key[1]] = stacked_rows_check(
            plan.arrays, plan._charges([r[1] for r in batch]), kp, cfg,
            plan.kernel, f"12c bucket {key[1]}", rows)
    lat = sorted(fe.latencies[len(fe.latencies) // 2:])
    print(f"[12c] ServeFrontend(max_batch 8), 24 requests of "
          f"{SERVE_REQUEST_SIZES} points, kappas {SERVE_KAPPAS}, forces "
          f"every third: {s1['num_buckets']} buckets, {s1['flushes']} "
          f"flushes, occupancy mean {s1['occupancy_mean']:.3f}, compiles "
          f"{s1['compiles']} (bar {s1['num_buckets']} buckets x {kinds} "
          f"kinds), retraces {s1['retraces']}, capacity growths "
          f"{s1['capacity_growths']}; {first_ms:.1f} ms wall; launches "
          f"{launched}", flush=True)
    print(f"[12c] the same 24 again: {again_ms:.1f} ms wall, "
          f"{warm['flushes']} flushes, compiles {warm['compiles']}, retraces "
          f"{warm['retraces']}, capacity growths {warm['capacity_growths']}; "
          f"latency p50 {lat[len(lat) // 2] * 1e3:.1f} ms, p99 "
          f"{lat[min(len(lat) - 1, round(0.99 * (len(lat) - 1)))] * 1e3:.1f}"
          f" ms (host clock, submit to resolve, warm pass; all requests: "
          f"p50 {s2['latency_p50'] * 1e3:.1f}, p99 "
          f"{s2['latency_p99'] * 1e3:.1f} ms); every request vs a "
          f"single-system plan max rel 2-norm {max(errs):.3e} (bar 1e-6); "
          f"each bucket's last flush, each kernel vs its plain version "
          f"(first {rows} batch rows of every slot; the modified charges on "
          f"every node; {STACKED_ROWS_RULE}), by bucket: max abs err "
          f"{worst}", flush=True)
    return fe, reqs


def phase_serve_md(dev):
    """12d: EnsembleMD of 8 replicas of a jittered 32^3 salt lattice
    (Coulomb, dt 1e-5), SERVE_MD_STEPS refit-only steps: the launches a
    step, every replica against a `Simulation(rebuild="never")` of the
    same system and its f64 energy balance, every kernel against its
    plain version on the refitted, skin-gated stacked arrays, and the
    integrator's share of a step."""
    import torch
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.dynamics import Simulation
    from repro_torch.dynamics.integrators import MDState
    from repro_torch.serve import EnsembleMD, EnsemblePlan

    cfg = dataclasses.replace(serve_config("coulomb"), skin=0.01)
    m = SERVE_MD_M
    # phase 8's lattice spacing, so its dt and step count hold here too
    # (steps move particles many f32 ulps, and end well before the
    # closest opposite pairs meet)
    spacing = 2.0 / MD_M
    systems = [salt_lattice(m, -0.5 * m * spacing, spacing, seed=300 + i)
               for i in range(8)]
    xs, qs = [s[0] for s in systems], [s[1] for s in systems]
    dt = 1e-5
    plan = EnsemblePlan.build(cfg, xs)
    md = EnsembleMD(plan, qs, dt=dt)
    torch.cuda.synchronize()
    phi0, v0 = md.state.phi.clone(), md.state.v.clone()
    zero_launch_counts()
    t0 = time.perf_counter()
    md.run(SERVE_MD_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / SERVE_MD_STEPS
    launched = launch_counts()
    want = (0, 2 * SERVE_MD_STEPS, SERVE_MD_STEPS, SERVE_MD_STEPS)
    assert launched == want, (launched, want)
    assert torch.isfinite(md.state.x).all()
    n = m ** 3
    dxs, balances = [], []
    for i, (x, q) in enumerate(zip(xs, qs)):
        sim = Simulation(TreecodeSolver(cfg).plan(x, capacities="auto"),
                         q, dt=dt, rebuild="never")
        sim.run(SERVE_MD_STEPS)
        dxs.append(rel2(md.split_positions()[i], sim.state.x))
        assert dxs[-1] <= 1e-6, (i, dxs[-1])
        del sim
        q64 = torch.as_tensor(q, device=dev).double()
        v = md.state.v[i, :n].double()
        dke = 0.5 * (v * v - v0[i, :n].double() ** 2).sum().item()
        dpe = 0.5 * (q64 * (md.state.phi[i, :n].double()
                            - phi0[i, :n].double())).sum().item()
        balances.append(abs(dke + dpe) / abs(dke))
        assert balances[-1] <= ENERGY_BAR, (i, dke, dpe)
    rows = 64
    worst = stacked_rows_check(md.arrays, md.charges, plan.kernel_params,
                               cfg, plan.kernel, "12d", rows)

    # the integrator's half-steps on the stacked state against a loop of
    # per-replica half-steps restacked (CUDA events, median of 7)
    st, f, phi, inv_m = md.state, md.state.f, md.state.phi, md._inv_m
    pre, post = md.integrator.pre, md.integrator.post

    def stacked_steps():
        post(pre(st, dt, inv_m), phi, f, dt, inv_m)

    def per_replica_steps():
        for half in (pre, post):
            out = [half(MDState(st.x[i], st.v[i], st.f[i], st.phi[i],
                                st.key[i]),
                        *((phi[i], f[i]) if half is post else ()), dt, inv_m)
                   for i in range(len(st.key))]
            MDState(*(torch.stack([getattr(o, k) for o in out])
                      for k in ("x", "v", "f", "phi")), key=st.key)
    integ_ms = event_ms(stacked_steps, 7)
    loop_ms = event_ms(per_replica_steps, 7)
    print(f"[12d] EnsembleMD of 8 replicas of a jittered {m}^3 salt lattice "
          f"(spacing {spacing}, {8 * n} particles), Coulomb, dt {dt}, skin "
          f"{cfg.skin}: "
          f"{SERVE_MD_STEPS} refit steps at {step_ms:.3f} ms a step (host "
          f"clock, synchronized); launches {launched} (batch_cluster, "
          f"modified_charges, field, grid field); every replica vs its own "
          f"Simulation(rebuild='never') positions rel 2-norm max "
          f"{max(dxs):.3e} (bar 1e-6); energy balance |dKE + dPE| / dKE "
          f"max {max(balances):.3e} over the replicas (bar {ENERGY_BAR})",
          flush=True)
    print(f"[12d] each kernel vs its plain version on the refitted, "
          f"skin-gated stack (first {rows} batch rows of every replica; the "
          f"modified charges on every node; {STACKED_ROWS_RULE}): max abs "
          f"err {worst}; the "
          f"integrator's two half-steps {integ_ms:.3f} ms on the stacked "
          f"state, {loop_ms:.3f} ms as a per-replica loop (CUDA events, "
          f"median of 7)", flush=True)


# The sharded phases: ranks stacked on the one card, the batch rows of
# each rank the kernels are held against their plain versions on, and the
# lattice of the sharded MD (MD_M^3 = 10^6 as phase 8's; see 13b).
SHARDED_P = 4
SHARDED_ROWS = 16
SHARDED_MD_M = MD_M


def lane_pairs(idx, tgt_count, src_count, nb, m, clusters=0):
    """(needed, swept) (target, source) pairs of one lane launch of the
    batch-cluster kernel: needed counts real targets x real sources of
    every valid slot, swept what its launch geometry runs
    (`bcm.swept_pairs`). A stacked lane (3-D idx) counts as one flat
    lane, system w's ids offset by w * clusters."""
    import torch
    from repro_torch.kernels import batch_cluster as bcm
    if idx.dim() == 3:
        off = (torch.arange(idx.shape[0], device=idx.device)
               * clusters)[:, None, None]
        idx = torch.where(idx >= 0, idx + off, idx).flatten(0, 1)
        tgt_count = tgt_count.flatten()
        src_count = None if src_count is None else src_count.flatten()
    valid = idx >= 0
    n = (torch.full(idx.shape, m, device=idx.device) if src_count is None
         else src_count.long()[idx.clamp(min=0).long()])
    needed = float((tgt_count.double()[:, None] * n * valid).sum())
    return needed, bcm.swept_pairs(idx, nb, m, tgt_count, src_count)["pairs"]


def sharded_rows_check(plan, q, what, rows=SHARDED_ROWS):
    """Each kernel of a sharded plan's path against its plain version on
    the tensors its sweeps feed them (`sharded_lane_inputs`, stacked on
    the card): batch_cluster on the four potential lanes, the grid field
    kernel on both approximation lanes and the field kernel on the local
    direct and halo lanes, each on the first `rows` batch rows of every
    rank (the remote lane's rows of each rank picked from its flattened
    R*B rows), and the modified charges on every node of every rank. phi
    per entry to PHI_K times its sum |G q|, gradients to GRAD_K times
    their sum |terms|, padded slots exactly 0. Returns {kernel: max abs
    err}; these launches are not counted."""
    import torch
    from repro_torch.distributed.bltc import LANE_OPS, sharded_lane_inputs
    from repro_torch.kernels import batch_cluster as bcm
    from repro_torch.kernels import ops
    a = plan.arrays
    q_rank = plan.rank_charges(q)
    opts = plan.exec_opts()
    kern = opts.pop("kernel")
    opts["backend"] = "cuda"
    pot = sharded_lane_inputs(a, q_rank, **opts)
    fld = sharded_lane_inputs(a, q_rank, grid_nodes=True, **opts)
    r, b = a["tgt_batched"].shape[:2]
    flat_rows = (torch.arange(r, device=q.device)[:, None] * b
                 + torch.arange(rows, device=q.device)).flatten()
    kw = dict(kernel=kern, space=plan.config.space)
    params = plan.kernel_params
    worst = {}

    def pick(t, flat):
        return t[flat_rows] if flat else t[:, :rows]

    for lane in pot:
        flat = lane == "remote_approx"
        mask = a["tgt_mask"].flatten(0, 1) if flat else a["tgt_mask"]
        real = pick(mask, flat)
        idx, tgt, pts, qq, cnt = pot[lane]
        sub = {k: (v if k == "src_count" else pick(v, flat))
               for k, v in cnt.items()}
        got, want = (ops.batch_cluster_eval(
            pick(idx, flat), pick(tgt, flat), pts, qq, params, backend=bk,
            **kw, **sub) for bk in ("cuda", "torch"))
        fidx, ftgt, fpts, fqq, fcnt = fld[lane]
        fsub = {k: (v if k == "src_count" else pick(v, flat))
                for k, v in fcnt.items()}
        op = LANE_OPS["field"][lane]
        plain = (bcm.batch_cluster_field_grid_plain
                 if op is ops.batch_cluster_field_grid
                 else bcm.batch_cluster_field_plain)
        fargs = (pick(fidx, flat), pick(ftgt, flat), fpts, fqq)
        fgot, fwant = (op(*fargs, params, backend=bk, **kw, **fsub)
                       for bk in ("cuda", "torch"))
        mag = plain(*fargs, params, magnitude=True, **kw, **fsub)[real]
        assert (got[~real] == 0).all(), f"{what}: batch_cluster {lane} pad"
        assert (fgot[~real] == 0).all(), f"{what}: field {lane} padding"
        e, _ = phi_close(got[real], want[real], mag[:, 0],
                         f"{what}: batch_cluster {lane}")
        worst["batch_cluster"] = max(worst.get("batch_cluster", 0.0), e)
        fgot, fwant = fgot[real], fwant[real]
        e, _ = phi_close(fgot[:, 0], fwant[:, 0], mag[:, 0],
                         f"{what}: field {lane} phi")
        ge, _ = grad_close(fgot[:, 1:], fwant[:, 1:], mag[:, 1:],
                           f"{what}: field {lane}")
        key = ("batch_cluster_field_grid" if op is ops.batch_cluster_field_grid
               else "batch_cluster_field")
        worst[key] = max(worst.get(key, 0.0), e, ge)
    inp_q = ops.take(q_rank, a["charges_perm"], True)
    mc_args = (a["src_sorted"], inp_q, a["mc_chunks"], a["mc_chunk_ptr"],
               a["node_lo"], a["node_hi"])
    qh, qh_plain = (ops.modified_charges_ranged(
        *mc_args, degree=plan.config.degree, backend=bk)
        for bk in ("cuda", "torch"))
    worst["modified_charges"] = close(qh, qh_plain, 3e-3, 3e-4,
                                      f"{what}: modified_charges",
                                      scale="max")
    assert (qh[:, plan.scratch_node] == 0).all(), "scratch node q_hat"
    torch.cuda.synchronize()
    return worst


def phase_sharded(dev, smi, x, q, single=None):
    """13a: a SHARDED_P-rank sharded plan stacked on the card at Fig. 4
    on phase 4's points and charges (see the module docstring). `single`
    is phase 4's plan (built here when None), timed in the same run."""
    import numpy as np
    import torch
    from repro_torch.core import eval as ev
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.core.direct import direct_field, direct_sum
    from repro_torch.distributed.bltc import LANE_OPS, sharded_lane_inputs

    cfg = fig4_config()
    solver = TreecodeSolver(cfg)
    n, p = x.shape[0], SHARDED_P
    if single is None:
        single = solver.plan(x)
    t0 = time.perf_counter()
    plan = solver.plan(x, nranks=p)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    st = plan.stats()
    caps, rc = st["capacities"], st["capacities"]["rank"]
    print(f"[13a] sharded plan at Fig. 4, N={n}, P={p} ranks stacked on the "
          f"card: host build {build_ms:.1f} ms, by phase "
          f"{ {k: round(v, 1) for k, v in st['build_phases'].items()} }; "
          f"rank counts {st['rank_counts']}; budget: slab width "
          f"{caps['slab_width']}, per rank batches {rc['num_batches']} x "
          f"{rc['batch_width']}, leaves {rc['num_leaves']} x "
          f"{rc['leaf_width']}, nodes {rc['num_nodes']}, approx width "
          f"{rc['approx_width']}, direct width {rc['direct_width']}, chunks "
          f"{rc['num_chunks']}; remote approx width "
          f"{caps['remote_approx_width']}, remote direct width "
          f"{caps['remote_direct_width']}; halo rounds {st['halo_rounds']} "
          f"(offsets {caps['halo_offsets']}, {st['halo_rounds_active']} "
          f"active), halo width {caps['halo_width']} leaves a round",
          flush=True)

    # the sharded path: every launch counter from 0 just before, read
    # just after
    reps_ex, reps_pf = 7, 3
    zero_launch_counts()
    phi = plan.execute(q)
    torch.cuda.synchronize()
    ex_ms = event_ms(lambda: plan.execute(q), reps_ex)
    ex_launches = launch_counts()
    zero_launch_counts()
    fphi, force = plan.potential_and_forces(q)
    torch.cuda.synchronize()
    pf_ms = event_ms(lambda: plan.potential_and_forces(q), reps_pf)
    pf_launches = launch_counts()
    calls_ex, calls_pf = 1 + reps_ex, 1 + reps_pf
    assert ex_launches == (4 * calls_ex, 2 * calls_ex, 0, 0), ex_launches
    assert pf_launches == (0, 2 * calls_pf, 2 * calls_pf,
                           2 * calls_pf), pf_launches
    single_ex = event_ms(lambda: single.execute(q), reps_ex)
    single_pf = event_ms(lambda: single.potential_and_forces(q), reps_pf)

    rng = np.random.default_rng(2020 + 13)
    sample = torch.as_tensor(rng.choice(n, 1000, replace=False), device=dev)
    x64 = torch.as_tensor(x, dtype=torch.float64, device=dev)
    q64 = q.double()
    ref = direct_sum(x64[sample], x64, q64, kernel=solver.kernel,
                     source_chunk=1 << 15)
    _, grad = direct_field(x64[sample], x64, q64, kernel=solver.kernel,
                           source_chunk=1 << 14)
    assert phi.shape == (n,) and torch.isfinite(phi).all()
    assert force.shape == (n, 3) and torch.isfinite(force).all()
    err = rel2(phi[sample].double(), ref)
    ferr = rel2(force[sample].double(), -q64[sample, None] * grad)
    serr = rel2(single.execute(q)[sample].double(), ref)
    assert err <= 1e-5, err
    assert ferr <= FORCE_BAR, ferr
    print(f"[13a] execute {ex_ms:.3f} ms (median of {reps_ex}, CUDA events) "
          f"against the single plan's {single_ex:.3f} ms: "
          f"{ex_ms / single_ex:.3f}x; potential_and_forces {pf_ms:.3f} ms "
          f"(median of {reps_pf}) against {single_pf:.3f} ms: "
          f"{pf_ms / single_pf:.3f}x ({smi}); launches over {calls_ex} "
          f"executes (batch_cluster, modified_charges, field, grid field) "
          f"{ex_launches}, over {calls_pf} force calls {pf_launches}; "
          f"relative 2-norm error vs f64 direct sum on 1000 sampled targets:"
          f" phi {err:.3e} (bar 1e-5; the single plan {serr:.3e}), forces "
          f"{ferr:.3e} (bar {FORCE_BAR})", flush=True)

    worst = sharded_rows_check(plan, q, "[13a]")
    print(f"[13a] kernels vs plain on the first {SHARDED_ROWS} batch rows "
          f"of each of the {p} ranks on all four lanes, the modified "
          f"charges on every node of every rank (phi {PHI_K[4]} sum|G q|, "
          f"gradient {GRAD_K[4]} sum|terms| per entry, q_hat rtol 3e-3 atol "
          f"3e-4 max|q_hat|; the scratch node's q_hat 0): max abs err "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }",
          flush=True)

    # pairs per lane: the potential kernel's launches, against the single
    # plan's two lanes; each sharded lane's ms
    opts = plan.exec_opts()
    kern = opts.pop("kernel")
    q_rank = plan.rank_charges(q)
    lanes = sharded_lane_inputs(plan.arrays, q_rank, **opts)
    fields = sharded_lane_inputs(plan.arrays, q_rank, grid_nodes=True,
                                 **opts)
    nb = plan.arrays["tgt_batched"].shape[2]
    kw = dict(kernel=kern, space=cfg.space, backend="cuda")
    out, tot = [], [0.0, 0.0]
    for lane, (idx, tgt, pts, qq, cnt) in lanes.items():
        need, swept = lane_pairs(idx, cnt["tgt_count"], cnt.get("src_count"),
                                 nb, pts.shape[-2], pts.shape[-3])
        ms = event_ms(lambda: LANE_OPS["lane"][lane](
            idx, tgt, pts, qq, plan.kernel_params, **kw, **cnt), 3)
        fidx, ftgt, fpts, fqq, fcnt = fields[lane]
        fms = event_ms(lambda: LANE_OPS["field"][lane](
            fidx, ftgt, fpts, fqq, plan.kernel_params, **kw, **fcnt), 3)
        tot[0] += need
        tot[1] += swept
        out.append(f"{lane} {need:.4e} needed, {swept:.4e} swept, "
                   f"{ms:.3f} ms (its field lane "
                   f"{LANE_OPS['field'][lane].__name__} {fms:.3f} ms)")
    s_lanes = ev.lane_inputs(single.arrays, q, degree=cfg.degree,
                             space=cfg.space, backend="cuda")
    snb = single.arrays["tgt_batched"].shape[1]
    s_out, s_tot = [], 0.0
    for lane, (idx, pts, qq, cnt) in s_lanes.items():
        need, swept = lane_pairs(idx, cnt["tgt_count"], cnt.get("src_count"),
                                 snb, pts.shape[-2])
        s_tot += need
        s_out.append(f"{lane} {need:.4e} needed, {swept:.4e} swept")
    print(f"[13a] pairs of the potential kernel's launches and each "
          f"lane's ms (median of 3, CUDA events), sharded: "
          + "; ".join(out) + f"; in all {tot[0]:.4e} needed, {tot[1]:.4e} "
          f"swept; the single plan: " + "; ".join(s_out)
          + f"; in all {s_tot:.4e} needed ({tot[0] / s_tot:.3f}x)",
          flush=True)


def phase_sharded_md(dev):
    """13b: `Simulation` over a SHARDED_P-rank sharded plan stacked on the
    card at the Fig. 4 settings with phase 8's MD (jittered
    SHARDED_MD_M^3 lattice, +-1 charges, skin MD_SKIN, dt MD_DT, refit
    interval MD_REFIT, MD_STEPS steps, host rebuilds into the
    ShardedCapacities budget). Steps 2.. run with every launch counter
    at 0 (2 field, 2 grid field and 2 modified-charge launches a step);
    each refit step makes exactly one host sync; no capacity growth and
    no kernel build after step 1; the energy balance in f64."""
    import warnings
    import torch
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.dynamics import Simulation
    from repro_torch.obs import events, trace

    m = SHARDED_MD_M
    x, q = salt_lattice(m, -1.0, 2.0 / m, 31)
    n = x.shape[0]
    t0 = time.perf_counter()
    cfg = dataclasses.replace(fig4_config(), skin=MD_SKIN)
    plan = TreecodeSolver(cfg).plan(x, nranks=SHARDED_P)
    sim = Simulation(plan, q, dt=MD_DT, refit_interval=MD_REFIT)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    sim.log.record(0, sim.diagnostics())
    phi0, v0 = sim.state.phi.clone(), sim.state.v.clone()
    sim.step()
    torch.cuda.synchronize()
    builds0 = events.build_count()
    zero_launch_counts()
    step_ms = {"refit": [], "rebuild": []}
    syncs = []
    for _ in range(MD_STEPS - 1):
        refits0 = sim.refits
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sim.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kind = "refit" if sim.refits > refits0 else "rebuild"
        if kind == "refit":
            syncs.append(sum("called a synchronizing CUDA operation"
                             in str(w.message) for w in caught))
        step_ms[kind].append(ms)
    launches = launch_counts()
    steps = MD_STEPS - 1
    assert launches == (0, 2 * steps, 2 * steps, 2 * steps), launches
    sim.log.record(sim.steps, sim.diagnostics())
    st = sim.stats()
    builds = events.build_count() - builds0
    assert st["capacity_growths"] == 0 and st["retraces"] == 0, st
    assert builds == 0, builds
    assert syncs and all(k == 1 for k in syncs), syncs
    assert st["rebuilds"] >= 1, st
    assert torch.isfinite(sim.state.x).all() and torch.isfinite(
        sim.state.f).all()
    dke, dpe = energy_balance(sim, phi0, v0)
    balance = abs(dke + dpe) / dke
    assert dke > 0 and balance <= ENERGY_BAR, (dke, dpe)
    worst = sharded_rows_check(sim.plan, sim.charges, "[13b]")
    # span breakdown of two more refit steps, traced (tracing syncs
    # inside each span): the engine's phases and the sweep's lanes
    trace.clear()
    trace.enable()
    try:
        for _ in range(2):
            sim.step()
    finally:
        trace.disable()
    spans = {k: v / 2 for k, v in trace.phase_totals().items()
             if k.startswith(("md.", "eval.", "sharded."))}
    med = {k: (statistics.median(v) if v else float("nan"))
           for k, v in step_ms.items()}
    pst = st["plan"]
    print(f"[13b] sharded MD at Fig. 4, N={n} (jittered {m}^3 lattice, +-1 "
          f"charges), P={SHARDED_P} stacked, host rebuilds, skin {MD_SKIN}, "
          f"velocity Verlet, dt {MD_DT}, refit interval {MD_REFIT}: setup "
          f"{setup_ms:.0f} ms (host build by phase "
          f"{ {k: round(v, 1) for k, v in pst['build_phases'].items()} }); "
          f"steps 2-{MD_STEPS}: {sum(map(sum, step_ms.values())):.1f} ms in "
          f"all; {len(step_ms['refit'])} refit steps, median "
          f"{med['refit']:.2f} ms, {len(step_ms['rebuild'])} rebuild steps, "
          f"median {med['rebuild']:.1f} ms (host clock to a synchronize); "
          f"refits {st['refits']}, rebuilds {st['rebuilds']} (drift "
          f"{st['rebuilds_drift']}, interval {st['rebuilds_interval']}); "
          f"over steps 0-{MD_STEPS} in f64 dKE {dke:.6e}, dPE {dpe:.6e}, "
          f"|dKE + dPE| / dKE {balance:.3e} (bar {ENERGY_BAR}); capacity "
          f"growths {st['capacity_growths']}, retraces {st['retraces']}, "
          f"kernel builds after step 1 {builds}; host syncs per refit step "
          f"{sorted(set(syncs))}; launches over steps 2-{MD_STEPS} "
          f"(batch_cluster, modified_charges, field, grid field) "
          f"{launches}; kernels vs plain on the MD's refitted plan "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }",
          flush=True)
    print(f"[13b] traced refit step, ms per step by span: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(spans.items())), flush=True)


#: PR 18's run-2 readings (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
#: section 5): phase 4's warm execute and phase 8's refit step medians,
#: printed beside this run's (the default path must not move).
PR18_EXECUTE_MS, PR18_REFIT_MS = 66.233, 80.15
#: Lattice side of phase 15d's NaN-mode MD (46^3 = 97,336 particles).
NAN_MD_M = 46


def phase_checking_tools(dev, smi, plan, x, q, md_sim=None, dplan=None,
                         serve=None):
    """15: the checking tools (`repro_torch.lint`, `obs.transfers`,
    `launch.dryrun_bltc`) on the card. (15a) the lint over
    src/repro_torch exits 0; (15b) under `no_implicit_syncs()` 7 warm
    executes and 3 warm force calls on phase 4's plan with no pull, 5 MD
    refit steps of phase 8's simulation with exactly one (the drift),
    taken in turn with 5 unguarded ones (both timed), a
    warm 12c resubmission whose only pulls are its uploads, host builds
    and results, and a 10^6 `replan_async` dispatch with none; (15c)
    transfer counts of a warm execute (no DtoH, no HtoD) and of a refit
    step (one DtoH); (15d) REPRO_DEBUG_NANS=1: a 10^5 MD of 3 clean
    steps, a NaN charge raising at the first kernel entry that sees it,
    and the execute's ms with the mode on and off; (15e) the meta dry run
    of the sharded plan for one rank of 256 and 512. `md_sim`, `dplan` and `serve` (phases 8, 10
    and 12c's) are built here when None."""
    import numpy as np
    import torch
    from repro_torch.configs.bltc import fig4
    from repro_torch.core.api import TreecodeSolver
    from repro_torch.dynamics import Simulation
    from repro_torch.launch import dryrun_bltc
    from repro_torch.lint import runtime as rt
    from repro_torch.obs.transfers import count_transfers
    from repro_torch.serve import ServeFrontend

    t_phase = time.perf_counter()
    # -- 15a: the lint --------------------------------------------------
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch.lint",
                          "src/repro_torch", "--summary"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lint = json.loads(res.stdout.strip().splitlines()[-1])
    assert lint["findings"] == 0, lint
    print(f"[15a] python -m repro_torch.lint src/repro_torch: exit 0, "
          f"{lint['hot_functions']} hot functions, {lint['findings']} "
          f"findings, {lint['suppressions']} reasoned suppressions "
          f"{lint['suppressions_by_rule']} ({time.perf_counter() - t0:.1f}"
          f" s)", flush=True)

    # -- 15b: the sync guard ----------------------------------------------
    plan.execute(q)
    plan.potential_and_forces(q)
    torch.cuda.synchronize()

    def warm_calls():
        for _ in range(7):
            plan.execute(q)
        for _ in range(3):
            plan.potential_and_forces(q)

    ex = guarded(warm_calls)
    assert ex == ({}, 0), ex
    if md_sim is None:
        xl, ql = salt_lattice(MD_M, -1.0, 2.0 / MD_M, 31)
        cfg = dataclasses.replace(fig4(theta=0.7, degree=8), skin=MD_SKIN)
        md_sim = Simulation(TreecodeSolver(cfg).plan(xl, capacities="auto"),
                            ql, dt=MD_DT, refit_interval=MD_REFIT)
        md_sim.step()
    # refit steps taken in turn under the guard and on the default path
    # (no guard, the debug mode "default"), each timed as phase 8 times
    # its steps: host clock to a synchronize
    refit_pulls, refit_ms, steps = [], {"guarded": [], "default": []}, 0
    while min(len(v) for v in refit_ms.values()) < 5 and steps < 24:
        refits = md_sim.refits
        guard = len(refit_ms["guarded"]) <= len(refit_ms["default"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pulls = guarded(md_sim.step) if guard else md_sim.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps += 1
        if md_sim.refits > refits:
            refit_ms["guarded" if guard else "default"].append(ms)
            if guard:
                refit_pulls.append(pulls)
    assert len(refit_pulls) == 5 and all(
        p == ({"drift": 1}, 1) for p in refit_pulls), refit_pulls
    assert len(refit_ms["default"]) == 5, refit_ms
    READINGS.update({f"[15b] refit_ms {k}": statistics.median(v)
                     for k, v in refit_ms.items()})
    if serve is None:
        serve = (ServeFrontend(serve_config(), max_batch=8), [
            (np.random.default_rng(i).uniform(-1, 1, (n, 3)).astype(
                np.float32), np.random.default_rng(i).uniform(
                    -1, 1, n).astype(np.float32),
             {"kappa": SERVE_KAPPAS[i % 3]}, i % 3 == 0)
            for i, n in enumerate(SERVE_REQUEST_SIZES * 8)])
    fe, reqs = serve

    def resubmit():
        futs = [fe.submit(xr, qr, kernel_params=pr, forces=fr)
                for xr, qr, pr, fr in reqs]
        fe.flush()
        return [f.result() for f in futs]

    resubmit()                                   # warm (when built here)
    s0 = fe.stats()
    serve_pulls = guarded(resubmit)
    s1 = fe.stats()
    assert set(serve_pulls[0]) <= {"serve_plan_build", "host_build",
                                   "upload", "serve_result"}, serve_pulls
    assert s1["retraces"] == s0["retraces"], (s0, s1)
    if dplan is None:
        dcfg = dataclasses.replace(fig4(theta=0.7, degree=8),
                                   build_backend="device")
        dplan = TreecodeSolver(dcfg).plan(x, capacities="auto")
    xd = torch.as_tensor(x, device=dev)
    torch.cuda.synchronize()
    (disp, pending) = guarded(dplan.replan_async, xd, out=True)
    _, wait_ms, grew = pending.finalize()
    assert disp == ({}, 0) and not grew, disp
    print(f"[15b] under no_implicit_syncs() (set_sync_debug_mode('error'); "
          f"the mode 'warn' outside it for the old count): 7 warm executes "
          f"and 3 warm potential_and_forces at Fig. 4, 10^6: explicit pulls "
          f"{ex[0]}, debug-mode warnings {ex[1]}; 5 MD refit steps of "
          f"phase 8's lattice ({steps} steps run, 5 more refit steps among "
          f"them unguarded): explicit pulls per refit "
          f"step {sorted({str(p[0]) for p in refit_pulls})}, warnings per "
          f"refit step {sorted({p[1] for p in refit_pulls})}; refit step ms "
          f"guarded {[round(v, 2) for v in refit_ms['guarded']]}, unguarded "
          f"{[round(v, 2) for v in refit_ms['default']]}; warm 12c "
          f"resubmission of {len(reqs)} requests: explicit pulls "
          f"{serve_pulls[0]}, warnings {serve_pulls[1]}, retraces "
          f"{s1['retraces'] - s0['retraces']}; replan_async dispatch at "
          f"10^6: explicit pulls {disp[0]}, warnings {disp[1]} (finalize "
          f"waited {wait_ms:.2f} ms)", flush=True)

    # -- 15c: transfer counts --------------------------------------------
    def brief(c):
        return (f"DtoH {c['DtoH']['count']} ({c['DtoH']['bytes']} B), HtoD "
                f"{c['HtoD']['count']} ({c['HtoD']['bytes']} B), DtoD "
                f"{c['DtoD']['count']}, syncs "
                f"{ {k: v for k, v in c['syncs'].items() if v} }, kernels "
                f"{c['kernels']}")

    _, cx = count_transfers(plan.execute, q)
    cs, lost = None, 0
    for _ in range(20):
        refits = md_sim.refits
        _, c = count_transfers(md_sim.step)
        if md_sim.refits == refits:
            continue
        # a trace holding the pull's wait but not its copy lost a record
        # (on an H100 in about half the traces: the sync and 216-247
        # kernels, no memcpy)
        if c["DtoH"]["count"] == 0 and c["syncs"]["cudaStreamSynchronize"]:
            lost += 1
            continue
        cs = c
        break
    assert cs is not None, (f"no refit step with a whole trace in 20 "
                            f"tries ({lost} lost their copy)")
    assert cx["kernels"] > 0 and cs["kernels"] > 0, \
        ("the profiler saw no kernel", cx, cs)
    assert cx["DtoH"]["count"] == 0 and cx["HtoD"]["count"] == 0, cx
    assert cs["DtoH"]["count"] == 1, cs
    print(f"[15c] obs.transfers.count_transfers: warm execute {brief(cx)}; "
          f"MD refit step {brief(cs)} (traces that lost the copy's record "
          f"first: {lost})", flush=True)

    # -- 15d: REPRO_DEBUG_NANS=1 ------------------------------------------
    off_ms = event_ms(lambda: plan.execute(q), 7)
    prev_env = os.environ.get("REPRO_DEBUG_NANS")
    os.environ["REPRO_DEBUG_NANS"] = "1"
    prev_mode = rt.DEBUG_NANS
    try:
        xs, qs = salt_lattice(NAN_MD_M, -1.0, 2.0 / NAN_MD_M, 5)
        cfg = dataclasses.replace(fig4(theta=0.7, degree=8), skin=MD_SKIN)
        sim = Simulation(TreecodeSolver(cfg).plan(xs, capacities="auto"),
                         qs, dt=MD_DT, refit_interval=MD_REFIT)
        assert sim.debug_nans is True and rt.DEBUG_NANS is True
        n0 = rt.sync_counts().get("debug_nans", 0)
        sim.run(3)
        checks = rt.sync_counts().get("debug_nans", 0) - n0
        assert checks > 0 and torch.isfinite(sim.state.f).all()
        on_ms = event_ms(lambda: plan.execute(q), 7)
        q_nan = q.clone()
        q_nan[q.shape[0] // 8] = float("nan")
        try:
            plan.execute(q_nan)
            raise AssertionError("REPRO_DEBUG_NANS missed a NaN charge")
        except FloatingPointError as e:
            caught = str(e)
        assert "modified_charges_ranged" in caught, caught
        del sim
    finally:
        rt.set_debug_nans(prev_mode)
        if prev_env is None:
            os.environ.pop("REPRO_DEBUG_NANS", None)
        else:
            os.environ["REPRO_DEBUG_NANS"] = prev_env
    print(f"[15d] REPRO_DEBUG_NANS=1: a {NAN_MD_M}^3 = {NAN_MD_M ** 3} "
          f"particle MD took 3 clean steps ({checks} output checks, no "
          f"false positive); a NaN charge at Fig. 4 raised "
          f"FloatingPointError: {caught!r}; warm execute median "
          f"{on_ms:.3f} ms with the mode on against {off_ms:.3f} ms off "
          f"(CUDA events, 7 each, same plan; {smi})", flush=True)

    # -- 15e: the dry run ---------------------------------------------------
    for nranks, multi in ((256, False), (512, True)):
        r = dryrun_bltc.dry_run(nranks, 262_144, multi)
        assert r["phi_shape"] == [nranks * 262_144], r
        f = r["forces"]
        print(f"[15e] dry run of the sharded plan's execute and "
              f"potential_and_forces, one rank of mesh {r['mesh']} x "
              f"262,144 points per rank (meta tensors, {r['dry_run_s']:.2f} "
              f"s host): per rank argument bytes "
              f"{r['per_rank']['argument_bytes']} (of them "
              f"{r['per_rank']['replicated_input_bytes']} the input-order "
              f"charges and slot table every rank holds); execute: peak live "
              f"output bytes {r['per_rank']['peak_live_output_bytes']}, "
              f"bytes read and written {r['bytes_per_rank']}, collective "
              f"bytes received {r['collective_bytes_per_rank']} "
              f"{r['collectives']}; potential_and_forces: peak live output "
              f"bytes {f['peak_live_output_bytes']}, bytes read and written "
              f"{f['bytes']}, collective bytes received "
              f"{f['collective_bytes']}; model interactions "
              f"{r['model_interactions_per_rank']}, FLOP term "
              f"{r['roofline']['compute_s'] * 1e3:.3f} ms and the execute's "
              f"bytes term {r['roofline']['memory_s'] * 1e3:.3f} ms at the "
              f"H100 SXM data-sheet peaks", flush=True)
    ex_ms = READINGS.get("[4] execute_ms")

    def r2(v):
        return v if v is None else round(v, 2)

    print(f"[15] default path (no guard, debug mode 'default', "
          f"REPRO_DEBUG_NANS off): phase 4 warm execute median "
          f"{ex_ms if ex_ms is None else round(ex_ms, 3)} ms against "
          f"{PR18_EXECUTE_MS} ms; 15b's unguarded refit step median "
          f"{r2(READINGS['[15b] refit_ms default'])} ms beside its guarded "
          f"one {r2(READINGS['[15b] refit_ms guarded'])} ms (taken in turn "
          f"on one simulation) and phase 8's (every step guarded) "
          f"{r2(READINGS.get('[8] refit_ms'))} ms, against {PR18_REFIT_MS} "
          f"ms (PR 18 run 2, NVIDIA H100 80GB HBM3, 700.00 W, its steps "
          f"under the debug mode 'warn'); this run on {smi}; phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


LM_PROMPT, LM_STEPS = 16, 4          # 16a: each arch at its SMOKE config
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_STEPS = 4, 512, 32   # 16b
FULL_REL, FULL_AGREE = 3e-2, 0.9
F32_REL = 1e-3           # 16c: decode against full forward in f32


class _Forward:
    """A module whose named attributes are replaced."""

    def __init__(self, real, **over):
        self._real = real
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._real, name)


@contextlib.contextmanager
def moe_routes():
    """The (expert indices (G, Sg, K), dispatch (G, Sg, E, C)) of every
    `moe.moe_apply` call in the block, in call order, into the list
    yielded: its `top_k` and dispatch einsum wrapped for the block."""
    import torch
    from repro_torch.models import moe
    routes, last = [], []
    real_top_k = moe.top_k

    def top_k(probs, k):
        out = real_top_k(probs, k)
        last[:] = [out[1]]
        return out

    def einsum(spec, *ops):
        if spec == "gsec,gsd->egcd":
            routes.append((last[0], ops[0]))
        return torch.einsum(spec, *ops)

    moe.top_k, moe.torch = top_k, _Forward(torch, einsum=einsum)
    try:
        yield routes
    finally:
        moe.top_k, moe.torch = real_top_k, torch


def lm_batch(cfg, rng, n_tokens, dev):
    """Random tokens (int32) and the stub frames / patches of a family."""
    import torch
    b = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (2, n_tokens)).astype("int32"), device=dev)}
    if cfg.family == "encdec":
        b["frames"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.src_seq, cfg.d_model)).astype("float32"), device=dev)
    if cfg.family == "vlm":
        b["patches"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.n_patches, cfg.vision_dim)).astype("float32"), device=dev)
    return b


def lm_serve(model, params, batch, dev):
    """Prefill LM_PROMPT tokens into a cache of LM_PROMPT + LM_STEPS (+
    n_patches), then LM_STEPS decode steps: [prefill logits, step
    logits...] and the MoE routes of every call."""
    cfg = model.cfg
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    with moe_routes() as routes:
        logits, cache = model.prefill(
            params, dict(batch, tokens=batch["tokens"][:, :LM_PROMPT]),
            cache_len=LM_PROMPT + LM_STEPS + extra, device=dev)
        out = [logits]
        for i in range(LM_PROMPT, LM_PROMPT + LM_STEPS):
            logits, cache = model.decode(params, {
                "tokens": batch["tokens"][:, i:i + 1], "cache": cache})
            out.append(logits)
    return out, [picks for picks, _ in routes]


def phase_lm_smoke(dev):
    """16a: every LM arch at its SMOKE config in f32 (TF32 off): the
    parameters materialized on the CPU from a seed and carried to the
    card; prefill and decode on the card against the same port on the
    CPU (relative 2-norm <= 1e-4 on the prefill and every step's logits),
    the MoE archs routing every token to the same experts."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.models.api import Model
    from repro_torch.models.layers import materialize, tree_map

    worst, lines = 0.0, []
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_config(arch, smoke=True)
        model = Model(cfg)
        cpu_params = materialize(model.decls(), i, device="cpu")
        params = tree_map(lambda t: t.to(dev), cpu_params)
        batch = lm_batch(cfg, np.random.default_rng(100 + i),
                         LM_PROMPT + LM_STEPS, "cpu")
        want, want_routes = lm_serve(model, cpu_params, batch, "cpu")
        got, routes = lm_serve(model, params, tree_map(
            lambda t: t.to(dev), batch), dev)
        errs = [rel2(g.double().cpu(), w.double()) for g, w in zip(got, want)]
        assert all(np.isfinite(errs)) and max(errs) <= 1e-4, (arch, errs)
        assert len(routes) == len(want_routes)
        for r, w in zip(routes, want_routes):
            assert torch.equal(r.cpu(), w), f"{arch}: experts differ"
        worst = max(worst, max(errs))
        lines.append(f"{arch} {max(errs):.2e}" + (
            f" ({len(routes)} routings equal)" if routes else ""))
    torch.cuda.synchronize()
    print(f"[16a] LM archs at SMOKE, f32: prefill {LM_PROMPT} + {LM_STEPS} "
          f"decode steps on the card against the port on the CPU, max "
          f"relative 2-norm per arch (bar 1e-4): " + "; ".join(lines),
          flush=True)
    return worst


def phase_lm_full(dev, smi):
    """16b: gemma-7b at its FULL config (28 layers, d_model 3072, 16 heads
    of 256, d_ff 24576, vocab 256000, bf16), materialized on the card from
    a CUDA generator. Serves GEMMA_BATCH requests: prompts of GEMMA_PROMPT
    random tokens into a cache of GEMMA_PROMPT + GEMMA_STEPS, then
    GEMMA_STEPS greedy decode steps under `no_implicit_syncs()`; each
    step's logits against one full forward over the prompt and the
    generated tokens (the reference's invariant, relative 2-norm <=
    FULL_REL) and the greedy tokens equal in at least FULL_AGREE of the
    steps. CUDA events time the prefill and each step."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.api import Model
    from repro_torch.models.layers import materialize, param_count

    cfg = get_config("gemma-7b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = materialize(model.decls(), 7, device=dev)
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    b, s, steps = GEMMA_BATCH, GEMMA_PROMPT, GEMMA_STEPS
    rng = np.random.default_rng(2026)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)).astype(
        "int32"), device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    logits, cache = model.prefill(params, {"tokens": prompt},
                                  cache_len=s + steps, device=dev)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    (pulls, warned), (toks, outs) = guarded(
        lambda: lm_decode_steps(model, params, logits, cache, steps,
                                marks=marks), out=True)
    torch.cuda.synchronize()
    assert not pulls and warned == 0, (pulls, warned)
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(steps)]
    decode_ms = statistics.median(step_ms)
    full, _, _ = tf.lm_apply(cfg, params, torch.cat([prompt] + toks, 1))
    full = full[:, s:]                               # the decoded positions
    dec = torch.cat(outs, 1)
    errs = step_errs(dec, full)
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    assert torch.isfinite(dec).all() and max(errs) <= FULL_REL, errs
    assert agree >= FULL_AGREE, agree
    peak = torch.cuda.max_memory_allocated(dev)
    # one more step at the prefill's position (its K/V rewritten), under
    # the profiler: how much of a step the device works
    split = profile_split(lambda: model.decode(
        params, {"tokens": toks[0], "cache": cache}), 3,
        lambda name, cat: "ops")
    busy_ms, n_ops = split["ops"].get("ops", (0.0, 0))
    print(f"[16b] gemma-7b FULL ({param_count(model.decls()) / 1e9:.3f}e9 "
          f"parameters, bf16, materialized on the card in {mat_s:.1f} s) "
          f"serving {b} requests of {s} prompt tokens + {steps} greedy "
          f"decode steps ({smi}): prefill {prefill_ms:.3f} ms, decode "
          f"{decode_ms:.3f} ms a token (median of {steps} steps of {b} "
          f"tokens; min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{b * 1e3 / decode_ms:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; decode logits against one full forward "
          f"over the prompt and the generated tokens: relative 2-norm max "
          f"{max(errs):.3e}, mean {statistics.mean(errs):.3e} (bar "
          f"{FULL_REL}), greedy tokens equal in {agree:.4f} of "
          f"{b * steps} (bar {FULL_AGREE}); implicit syncs in the decode "
          f"loop: {warned} (explicit pulls {pulls or 0}); one step under "
          f"the profiler (median of 3): host enqueue {split['host']:.3f} "
          f"ms, device busy {busy_ms:.3f} ms in {n_ops} operations, idle "
          f"{split['gap']:.3f} ms of a {split['span']:.3f} ms span (idle "
          f"share {split['gap'] / split['span']:.3f})", flush=True)
    READINGS["[16b] decode_ms"] = decode_ms
    del params, cache, logits, full, dec, outs


#: 16c: (arch, requests, prompt tokens, greedy decode steps) at FULL
#: width and depth in bf16. granite's full forward holds 2 x 512 tokens:
#: one dispatch group of its moe_group 1024. llava's one request is 2880
#: patches + 5568 text tokens = 8448 > attn_dense_max 8192 positions: its
#: prefill and full forward take the KV-chunked attention.
FULL_SERVE = (("granite-moe-1b-a400m", 2, 480, 32),
              ("mamba2-1.3b", 2, 512, 32),
              ("zamba2-1.2b", 2, 512, 32),
              ("whisper-small", 2, 256, 32),
              ("llava-next-mistral-7b", 1, 5568, 32))


def lm_full_forward(cfg, params, batch):
    """The port's logits over all of `batch`'s tokens in one pass (for
    the VLM, over the patches and then the tokens)."""
    from repro_torch.models import llava as lv
    from repro_torch.models import mamba2 as mb
    from repro_torch.models import transformer as tf
    from repro_torch.models import whisper as wh
    toks = batch["tokens"]
    if cfg.family in ("dense", "moe"):
        return tf.lm_apply(cfg, params, toks)[0]
    if cfg.family == "ssm":
        return mb.mamba_lm_apply(cfg, params, toks)[0]
    if cfg.family == "hybrid":
        return mb.zamba_apply(cfg, params, toks)[0]
    if cfg.family == "encdec":
        return wh.decode_stack(cfg, params, toks,
                               wh.encode(cfg, params, batch["frames"]))[0]
    return lv.llava_apply(cfg, params, toks, batch["patches"])[0]


def expert_sets(picks, n_experts):
    """(..., K) expert indices -> (..., E) 0/1 rows of the chosen set."""
    import torch
    return (picks[..., None] == torch.arange(
        n_experts, device=picks.device)).any(-2).float()


def dispatch_holds(dispatch, picks, cap, k):
    """The capacity dispatch (G, Sg, E, C) of top-k choices (G, Sg, K):
    each slot holds at most one token, each token at most k slots, and
    each expert keeps min(assigned, C) tokens. Returns the kept share."""
    assigned = expert_sets(picks, dispatch.shape[2]).sum(1)        # (G, E)
    d = dispatch.float()
    assert bool((d.sum(1) <= 1).all()), "a slot holds two tokens"
    assert bool((d.sum((2, 3)) <= k).all()), "a token holds > k slots"
    kept = d.sum((1, 3))
    assert bool((kept == assigned.clamp(max=cap)).all()), "kept != min(n, C)"
    return float(kept.sum() / assigned.sum())


def lm_decode_steps(model, params, logits, cache, steps, forced=None,
                    marks=None):
    """`steps` decode steps after a prefill's `logits`: greedy, or fed
    the tokens `forced` (one (B, 1) tensor a step). Returns the tokens
    fed and each step's logits; `marks` (steps + 1 CUDA events) time
    the steps."""
    import torch
    toks, outs = [], []
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    if marks:
        marks[0].record()
    for i in range(steps):
        tok = tok if forced is None else forced[i]
        toks.append(tok)
        logits, cache = model.decode(params, {"tokens": tok, "cache": cache})
        if marks:
            marks[i + 1].record()
        outs.append(logits)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
    return toks, outs


def step_errs(dec, full):
    """Relative 2-norm of each decode step's logits against the full
    forward's at the same positions (both (B, steps, V))."""
    return [rel2(dec[:, i].float(), full[:, i].float())
            for i in range(dec.shape[1])]


def phase_lm_full_archs(dev, smi):
    """16c: the archs of FULL_SERVE at FULL width and depth in bf16,
    materialized on the card from a CUDA generator, serving their
    requests: prefill (timed), greedy decode steps under
    `no_implicit_syncs()` (each timed), each step's logits against one
    full forward over the prompt and the generated tokens.

    The same weights in f32 (TF32 off) then serve request 0 on the same
    tokens: its decode steps against its full forward within F32_REL
    (the cache path at the real shapes), and the bf16 full forward
    against the f32 one: bf16's own error on this model. With random
    weights the deep SSMs amplify a rounding (`tools/lm_bf16_noise.py`,
    on a CPU: a 2^-9 change of mamba2's embedding moves its f32 logits
    by 1.6e-2 at 8 layers and 6.3e-2 at 24), so the bf16 bar is the
    larger of FULL_REL and twice that error. The share of greedy tokens
    equal is printed, not held: two bf16 results pick different tokens
    wherever the top two logits lie within their errors, which the
    2-norm bar bounds, and random weights give many such near-ties.

    The MoE arch serves at a capacity that drops no token (C = the
    group: the cache path and the full forward group tokens
    differently), its decode steps choosing the full forward's experts
    in >= FULL_AGREE of the (token, layer, slot) choices; then one
    prefill of the full forward's 2 x 512 tokens at its own capacity
    factor (C = 320 of a group of 1024), whose dispatch keeps
    min(assigned, C) tokens an expert, its first layer's choices equal
    to the full forward's. llava's prefill (8448 positions) takes the
    KV-chunked attention, held against the dense one on its first
    request (relative 2-norm <= FULL_REL)."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as ly
    from repro_torch.models.api import Model
    from repro_torch.models.layers import materialize, param_count, tree_map

    print(f"[16c] FULL configs in bf16 on the card ({smi}), each step's "
          f"logits against one full forward (bars: max({FULL_REL}, twice "
          f"the bf16 forward's error against f32); f32 {F32_REL}):",
          flush=True)
    for seed, (arch, b, s, steps) in enumerate(FULL_SERVE):
        cfg = get_config(arch)
        own_capacity = cfg.capacity_factor
        if cfg.n_experts:
            cfg = dc.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        model = Model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = materialize(model.decls(), 20 + seed, device=dev)
        rng = np.random.default_rng(3000 + seed)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab, (b, s)).astype("int32"), device=dev)}
        gen = torch.Generator(device=dev).manual_seed(4000 + seed)
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(
                (b, cfg.src_seq, cfg.d_model), generator=gen,
                device=dev).to(cfg.adtype)
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(
                (b, cfg.n_patches, cfg.vision_dim), generator=gen,
                device=dev).to(cfg.adtype)
        extra = cfg.n_patches if cfg.family == "vlm" else 0
        cache_len = extra + s + steps
        chunked = [0]
        real_chunked = ly._chunked_attention

        def counted(*args):
            chunked[0] += 1
            return real_chunked(*args)

        ly._chunked_attention = counted
        try:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            logits, cache = model.prefill(params, batch, cache_len=cache_len,
                                          device=dev)
            end.record()
            torch.cuda.synchronize()
            prefill_ms, pre_chunked = start.elapsed_time(end), chunked[0]
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(steps + 1)]
            with moe_routes() as dec_routes:
                (pulls, warned), (toks, outs) = guarded(
                    lambda: lm_decode_steps(model, params, logits, cache,
                                            steps, marks=marks), out=True)
            torch.cuda.synchronize()
            assert not pulls and warned == 0, (arch, pulls, warned)
            step_ms = [marks[i].elapsed_time(marks[i + 1])
                       for i in range(steps)]
            decode_ms = statistics.median(step_ms)
            peak = torch.cuda.max_memory_allocated(dev)
            whole = dict(batch, tokens=torch.cat([batch["tokens"]] + toks,
                                                 1))
            with moe_routes() as full_routes:
                full = lm_full_forward(cfg, params, whole)[:, -steps:]
            dec = torch.cat(outs, 1)
            errs = step_errs(dec, full)
            agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
            assert torch.isfinite(dec).all() and torch.isfinite(full).all()
            line = (f"{arch} ({param_count(model.decls()) / 1e9:.3f}e9 "
                    f"parameters) {b} x {s} prompt tokens"
                    + (f" + {extra} patches" if extra else "")
                    + f" + {steps} steps: prefill {prefill_ms:.3f} ms, "
                    f"decode {decode_ms:.3f} ms a step (min "
                    f"{min(step_ms):.3f}, max {max(step_ms):.3f}), "
                    f"{b * 1e3 / decode_ms:.1f} tokens/s, peak "
                    f"{peak / 2**30:.2f} GiB, implicit syncs {warned}; "
                    f"decode vs full forward relative 2-norm max "
                    f"{max(errs):.3e}, mean {statistics.mean(errs):.3e}, "
                    f"greedy tokens equal in {agree:.4f} of {b * steps}")
            if cfg.n_experts:
                line += "; " + moe_full_checks(
                    model, params, whole, dec_routes, full_routes, s, steps,
                    own_capacity, dev)
            if extra:
                assert pre_chunked > 0, "llava's prefill was not chunked"
                dense = Model(dc.replace(cfg, attn_dense_max=extra + s))
                first = {k: v[:1] for k, v in batch.items()}
                n0 = chunked[0]
                want, _ = dense.prefill(params, first, cache_len=extra + s,
                                        device=dev)
                assert chunked[0] == n0, "the dense prefill was chunked"
                err = rel2(logits[:1].float(), want.float())
                assert err <= FULL_REL, ("chunked vs dense", err)
                line += (f"; prefill over {extra + s} positions through "
                         f"the KV-chunked attention ({pre_chunked} calls, "
                         f"chunk {cfg.attn_chunk}) against the dense one on "
                         f"request 0: relative 2-norm {err:.3e}")
                del want
            del cache, logits, outs
            # the same weights in f32, request 0 on the same tokens
            cfg32 = dc.replace(cfg, dtype="float32", param_dtype="float32")
            model32 = Model(cfg32)
            params32 = tree_map(lambda t: t.float(), params)
            del params
            first = {k: v[:1].float() if v.is_floating_point() else v[:1]
                     for k, v in batch.items()}
            lg32, cache32 = model32.prefill(params32, first,
                                            cache_len=cache_len, device=dev)
            _, outs32 = lm_decode_steps(model32, params32, lg32, cache32,
                                        steps, forced=[t[:1] for t in toks])
            del lg32, cache32
            whole32 = dict(first, tokens=whole["tokens"][:1])
            full32 = lm_full_forward(cfg32, params32, whole32)[:, -steps:]
            errs32 = step_errs(torch.cat(outs32, 1), full32)
            noise = step_errs(full[:1], full32)
            agree32 = (full[:1].argmax(-1) == full32.argmax(-1)).float() \
                .mean().item()
            bar = max(FULL_REL, 2 * max(noise))
            line += (f"; in f32 on request 0: decode vs full forward max "
                     f"{max(errs32):.3e}; the bf16 full forward against the "
                     f"f32 one max {max(noise):.3e}, mean "
                     f"{statistics.mean(noise):.3e}, greedy tokens equal in "
                     f"{agree32:.4f}")
            print(f"    {line}", flush=True)
            assert max(errs32) <= F32_REL, (arch, "f32", errs32)
            assert max(errs) <= bar, (arch, [round(e, 4) for e in errs], bar)
            del params32, outs32, full32, full, dec
        finally:
            ly._chunked_attention = real_chunked
        del batch, whole
    torch.cuda.empty_cache()


def moe_full_checks(model, params, whole, dec_routes, full_routes, s, steps,
                    capacity_factor, dev):
    """16c's MoE checks (see `phase_lm_full_archs`) on the full forward's
    tokens `whole`; returns their text."""
    import dataclasses as dc
    import torch
    from repro_torch.models.api import Model
    from repro_torch.models.moe import _capacity
    cfg = model.cfg
    nl, e, k = cfg.n_layers, cfg.n_experts, cfg.top_k
    b, t = whole["tokens"].shape
    assert len(full_routes) == nl and len(dec_routes) == nl * steps
    shares = []
    for layer in range(nl):
        fp = full_routes[layer][0].reshape(b, s + steps, k)[:, s:]
        for i in range(steps):
            dp = dec_routes[i * nl + layer][0].reshape(b, k)
            both = expert_sets(dp, e) * expert_sets(fp[:, i], e)
            shares.append(both.sum(-1) / k)
    overlap = torch.cat(shares).mean().item()
    assert overlap >= FULL_AGREE, ("experts", overlap)
    real = Model(dc.replace(cfg, capacity_factor=capacity_factor))
    with moe_routes() as routes:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out, _ = real.prefill(params, whole, cache_len=t, device=dev)
        end.record()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(routes[0][0], full_routes[0][0]), "layer 0 picks"
    group = min(real.cfg.moe_group, b * t)
    cap = _capacity(real.cfg, group)
    kept = [dispatch_holds(d, p, cap, k) for p, d in routes]
    return (f"experts of the decode steps in the full forward's sets: "
            f"{overlap:.4f} of {b * steps * nl * k} choices; prefill of "
            f"{b} x {t} tokens at capacity factor {real.cfg.capacity_factor} (groups of "
            f"{group}, C = {cap}) {start.elapsed_time(end):.3f} ms, "
            f"dispatch holds in all {len(kept)} layers, kept share of the "
            f"choices min {min(kept):.4f}, mean {statistics.mean(kept):.4f}")


# Phase 17 (LM training). 17a: each arch at its SMOKE config in f32, a
# batch of TRAIN_B x (TRAIN_S + 1) tokens, a MoE arch's dispatch groups
# one row each (moe_group = TRAIN_S) so that grad_accum's microbatches
# route as the whole batch does; AdamW at the launcher's lr.
TRAIN_B, TRAIN_S = 4, 16
TRAIN_REL = 1e-5           # card against CPU: loss, grads, a step's params
TRAIN_OPT = dict(lr=1e-3, warmup=2)
# An entry whose clipped gradient falls below 1000 x AdamW's eps is moved
# by about lr g / (|g| + eps), whose sensitivity to the gradient, lr eps /
# (|g| + eps)^2, turns the card's and the CPU's different f32 rounding
# (relative 1e-6 of a leaf's gradient) into more than 1e-5 of a small
# leaf's step: such entries are held to a step's reach (a sign flip of an
# Adam step, |u| <= 1.5), not to the leaf's norm.
TRAIN_NOISE = 1e-5
# 17c / 17d: (arch, batch, sequence, steps, warm steps, timed steps,
# AdamW's warmup, the margins by which the mean of the last 5 steps'
# losses and the loss on a held batch must fall; None: not held) at FULL
# width and depth in bf16. Over 4 steps the batches' own spread (+-0.03)
# hides the fall, so 17d holds the held batch's loss only, and warms up
# in one step.
TRAIN_FULL = (("internlm2-1.8b", 4, 2048, 30, 3, 10, 5, 0.1, 0.1),
              ("granite-moe-1b-a400m", 4, 1024, 5, 1, 4, 1, None, 0.01),
              ("mamba2-1.3b", 4, 2048, 5, 1, 4, 1, None, 0.01))
# On an H100, lr 1e-3 (the launcher's) made internlm2's FULL loss rise:
# Adam's first steps are sign steps of lr, ~30% of a `wo` entry's init
# std; 3e-4 fell to step 10 and rose, 1e-4 fell by 0.2 over 30 steps
# (PERF.md)
FULL_TRAIN_LR = 1e-4
REMAT_REL = 1e-2           # bf16 grads with remat on against off
LOSS0_BAR = 0.05           # step 0's loss against its expectation


def train_config(arch):
    """`arch`'s SMOKE config for 17a (MoE groups of one batch row)."""
    import dataclasses as dc
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch, smoke=True)
    return dc.replace(cfg, moe_group=TRAIN_S) if cfg.n_experts else cfg


def train_batch(cfg, rng, dev, b=TRAIN_B, s=TRAIN_S):
    """b x (s + 1) tokens and a family's stub inputs, from `rng`."""
    import torch
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s + 1)).astype("int32")}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.src_seq, cfg.d_model)).astype("float32")
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.vision_dim)).astype("float32")
    return {k: torch.as_tensor(v, device=dev) for k, v in out.items()}


def tree_to(tree, dev):
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: t.detach().to(dev, copy=True), tree)


def leaf_rel2(got, want):
    """Largest relative 2-norm over the leaves (want on the CPU)."""
    from repro_torch.models.layers import tree_leaves
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().double().cpu(), w.double()
        den = float(w.norm())
        worst = max(worst, float((g - w).norm()) / (den or 1.0))
    return worst


def noisy_entries(grads_per_step):
    """Per leaf, the entries whose clipped gradient (clip_norm 1) falls
    below TRAIN_NOISE at some step."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.optimizers import global_norm
    masks = None
    for grads in grads_per_step:
        scale = min(1.0, 1.0 / max(float(global_norm(grads)), 1e-9))
        small = [g.abs() * scale < TRAIN_NOISE for g in tree_leaves(grads)]
        masks = small if masks is None else [a | b for a, b in
                                             zip(masks, small)]
    return masks


def step_rel2(got, want, noisy, lr):
    """Largest relative 2-norm over the leaves of one step's params on
    their determined entries; the others within a step's reach."""
    from repro_torch.models.layers import tree_leaves
    worst = 0.0
    for g, w, m in zip(tree_leaves(got), tree_leaves(want), noisy):
        g, w = g.detach().double().cpu(), w.double()
        d, keep = g - w, ~m
        den = float(w[keep].norm())
        worst = max(worst, float(d[keep].norm()) / (den or 1.0))
        if bool(m.any()):
            reach = 3 * lr * (1 + 0.1 * float(w[m].abs().max()))
            assert float(d[m].abs().max()) <= reach, "beyond a step's reach"
    return worst


def phase_train_smoke(dev, archs=None):
    """17a: every LM arch at its SMOKE config in f32 (TF32 off), its
    parameters materialized on the CPU and carried to the card: the
    port's `loss_and_grads` on the card against the CPU (loss and every
    grad leaf within a relative 2-norm of TRAIN_REL); three AdamW steps
    chained on both (each step's loss within TRAIN_REL) and each step on
    the card from the CPU's previous params and state (params per leaf
    within TRAIN_REL on their determined entries; the moments' errors
    printed: an EMA whose terms cancel carries more than the gradient's
    error, and the params hold what it moves); grad_accum 4
    against 1 on the card (the reference test's bounds: loss 1e-5,
    params 5e-5 max abs); remat on against off on the card (grads within
    1e-6). Returns the largest error of each kind."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.models.api import Model
    from repro_torch.models.layers import materialize, tree_leaves
    from repro_torch.optim.optimizers import AdamW
    from repro_torch.training.step import loss_and_grads, make_train_step

    worst = dict(grads=0.0, steps=0.0, accum_loss=0.0, accum_params=0.0,
                 remat=0.0)
    lines = []
    for i, arch in enumerate(archs or ARCH_IDS):
        cfg = train_config(arch)
        model = Model(cfg)
        rng = np.random.default_rng(300 + i)
        host = [train_batch(cfg, rng, "cpu") for _ in range(3)]
        card = [tree_to(b, dev) for b in host]
        p0 = materialize(model.decls(), 50 + i, device="cpu")
        (lc, _), gc = loss_and_grads(model, p0, host[0])
        (lg, _), gg = loss_and_grads(model, tree_to(p0, dev), card[0])
        e_loss = abs(float(lg) - float(lc)) / abs(float(lc))
        e_grad = leaf_rel2(gg, gc)
        assert e_loss <= TRAIN_REL and e_grad <= TRAIN_REL, (arch, e_loss,
                                                             e_grad)
        # three steps: chained on both; on the card from the CPU's state
        opt = AdamW(**TRAIN_OPT)
        step = make_train_step(model, opt)
        pc = tree_to(p0, "cpu")
        pg = tree_to(p0, dev)
        sc, sg = opt.init(pc), opt.init(pg)
        trail, seen = [(tree_to(pc, "cpu"), tree_to(sc, "cpu"))], []
        for t in range(3):
            seen.append(loss_and_grads(model, pc, host[t])[1])
            pc, sc, mc = step(pc, sc, host[t])
            pg, sg, mg = step(pg, sg, card[t])
            assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
                TRAIN_REL * abs(float(mc["loss"])), (arch, t)
            trail.append((tree_to(pc, "cpu"), tree_to(sc, "cpu")))
        noisy = noisy_entries(seen)
        e_step = e_m = e_v = 0.0
        for t in range(3):
            p, s = (tree_to(x, dev) for x in trail[t])
            p, s, _ = step(p, s, card[t])
            want_p, want_s = trail[t + 1]
            e_step = max(e_step, step_rel2(p, want_p, noisy,
                                           TRAIN_OPT["lr"]))
            e_m = max(e_m, leaf_rel2(s["m"], want_s["m"]))
            e_v = max(e_v, leaf_rel2(s["v"], want_s["v"]))
        assert e_step <= TRAIN_REL, (arch, e_step)
        # grad_accum 4 against 1, on the card
        accum_opt = AdamW(lr=1e-3, warmup=1)
        out = []
        for accum in (1, 4):
            p = tree_to(p0, dev)
            out.append(make_train_step(Model(dc.replace(
                cfg, grad_accum=accum)), accum_opt)(
                    p, accum_opt.init(p), card[0]))
        (p1, _, m1), (p4, _, m4) = out
        e_al = abs(float(m1["loss"]) - float(m4["loss"]))
        e_ap = max(float((a - b).abs().max())
                   for a, b in zip(tree_leaves(p1), tree_leaves(p4)))
        assert e_al < 1e-5 and e_ap < 5e-5, (arch, e_al, e_ap)
        # remat on against off, on the card
        (_, _), g_on = loss_and_grads(Model(dc.replace(cfg, remat=True)),
                                      tree_to(p0, dev), card[0])
        (_, _), g_off = loss_and_grads(Model(dc.replace(cfg, remat=False)),
                                       tree_to(p0, dev), card[0])
        e_remat = leaf_rel2(g_on, tree_to(g_off, "cpu"))
        assert e_remat <= 1e-6, (arch, e_remat)
        for k, v in (("grads", max(e_loss, e_grad)), ("steps", e_step),
                     ("accum_loss", e_al), ("accum_params", e_ap),
                     ("remat", e_remat)):
            worst[k] = max(worst[k], v)
        lines.append(f"{arch} {max(e_loss, e_grad):.2e}/{e_step:.2e}/"
                     f"{e_ap:.2e}/{e_remat:.2e} (moments {e_m:.1e}, "
                     f"{e_v:.1e})")
    torch.cuda.synchronize()
    print(f"[17a] LM training at SMOKE, f32, card against CPU: per arch "
          f"the largest relative 2-norm of the loss and grads / of a "
          f"step's params on its determined entries (bar {TRAIN_REL}) / "
          f"grad_accum 4 against 1, params max abs (bar 5e-5) / remat on "
          f"against off, grads (bar 1e-6): " + "; ".join(lines) +
          f"; worst {worst}", flush=True)
    return worst


def phase_train_launcher(dev):
    """17b: the launcher (`python -m repro_torch.launch.train`) at
    internlm2-1.8b's SMOKE config on the card, in subprocesses: 20 steps
    with a checkpoint every 10, then 40 steps from the same directory
    (it must print "resumed from step 20"), beside one uninterrupted
    40-step run; the two step-40 checkpoints (params and optimizer
    state) equal bitwise."""
    import tempfile
    import numpy as np

    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "internlm2-1.8b", "--smoke", "--device", str(dev)]

    def start(*args):
        return subprocess.Popen(base + list(args), env=env, cwd=ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish(proc, what):
        try:
            out, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, (what, out[-3000:])
        return out

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cut, whole = os.path.join(d, "cut"), os.path.join(d, "whole")
        first = start("--steps", "20", "--ckpt-every", "10", "--ckpt-dir",
                      cut)
        one = start("--steps", "40", "--ckpt-dir", whole)
        out1, out_whole = finish(first, "20 steps"), finish(one, "40 steps")
        out2 = finish(start("--steps", "40", "--ckpt-dir", cut), "resume")
        assert "resumed from step 20" in out2, out2[-2000:]
        assert "resumed" not in out1 + out_whole
        a, b = (os.path.join(d, "step_40") for d in (cut, whole))
        with open(os.path.join(a, "manifest.json")) as f:
            ma = json.load(f)["leaves"]
        with open(os.path.join(b, "manifest.json")) as f:
            mb = json.load(f)["leaves"]
        assert ma.keys() == mb.keys()
        for key in ma:
            x = np.load(os.path.join(a, ma[key]["file"]))
            y = np.load(os.path.join(b, mb[key]["file"]))
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tobytes() == y.tobytes(), f"{key} differs"
        leaves = len(ma)
    last = [l for l in out2.splitlines() if l.startswith("step")][-1]
    print(f"[17b] launcher at internlm2-1.8b SMOKE on the card: 20 steps "
          f"(checkpoints at 10, 20), then 40 from the same directory "
          f"(printed 'resumed from step 20'; {last.strip()!r}), beside one "
          f"uninterrupted 40-step run: the step-40 checkpoints equal "
          f"bitwise in all {leaves} leaves (params and AdamW state); "
          f"{time.perf_counter() - t0:.1f} s for the three runs",
          flush=True)


def train_model_flops(cfg, b, s):
    """Model FLOPs of one training step on b x s tokens: 6 per matmul
    parameter a token (the active experts' only; the embedding lookup
    none, a tied table's logits matmul its V x d) plus 3 times the
    sequence mixing's forward (attention 4 S hq hd a layer and token, as
    computed: the full S x S scores; the SSD's chunked scan 2 Q G N +
    2 Q H P + 4 H P N); recomputation not counted."""
    from repro_torch.models.api import Model
    from repro_torch.models.layers import param_count
    d, L, v = cfg.d_model, cfg.n_layers, cfg.vocab
    n = param_count(Model(cfg).decls()) - v * d * (not cfg.tie_embeddings)
    if cfg.n_experts:
        mats = 3 if cfg.act.endswith("_glu") else 2
        n -= L * cfg.n_experts * mats * d * cfg.d_ff * (
            1 - cfg.top_k / cfg.n_experts)
    if cfg.family == "ssm":
        q = min(cfg.ssm_chunk, s)
        h, p, nn, g = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                       cfg.ssm_groups)
        mix = L * (2 * q * g * nn + 2 * q * h * p + 4 * h * p * nn)
    else:
        mix = L * 4 * s * cfg.n_heads * cfg.hd
    return (6 * n + 3 * mix) * b * s


class _TimedOpt:
    """An optimizer whose `update` records a CUDA event before and after
    (the update's share of a step)."""

    def __init__(self, opt):
        self.opt, self.marks, self.on = opt, [], False

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        import torch
        if not self.on:
            return self.opt.update(grads, state, params)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.opt.update(grads, state, params)
        ev[1].record()
        self.marks.append(ev)
        return out


def init_loss(model, params, batch):
    """What step 0's loss should be: labels uncorrelated with the random
    model's logits z, so the CE's expectation is logsumexp(z) - mean(z),
    averaged over the positions (row 0 of the batch)."""
    import torch
    cfg = model.cfg
    with torch.no_grad():
        logits = lm_full_forward(cfg, params, {
            "tokens": batch["tokens"][:1, :-1]}).float()
        return float((torch.logsumexp(logits, -1) - logits.mean(-1)).mean())


def phase_train_full(dev, smi, tag, arch, b, s, steps, warm, timed, warmup,
                     margin, held_margin):
    """17c / 17d: `arch` at its FULL config (bf16, remat on), trained for
    `steps` AdamW steps (lr FULL_TRAIN_LR, `warmup`) on b x s tokens from
    `TokenSource` (seed 23, the batches materialized on the card first),
    its parameters materialized on the card. `warm` steps, then `timed`
    steps under `no_implicit_syncs()` (0 implicit syncs), each timed by
    CUDA events, the optimizer update apart; then the rest. Checks: step
    0's loss within LOSS0_BAR of its expectation (`init_loss`, plus
    aux_loss_coef times step 0's MoE aux loss, summed over layers), the mean
    of the last min(5, steps - 1) losses below step 0's by `margin`
    (unless None), the loss on a held batch (`batch_at(steps)`, not
    trained on; `make_eval_step`) below its value before training by
    `held_margin`, the grad norm finite and > 0 at every step; remat on
    against off on one 1 x s batch, grads within REMAT_REL. Prints the step time (median,
    min, max), tokens/s, peak memory, the update's share of a step, the
    model-FLOP rate against the bf16 dense peak, one profiled step's
    device idle share, and on the 1 x s batch a forward without autograd,
    a forward and backward without remat and one with it (remat's
    cost)."""
    import dataclasses as dc
    import math
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenSource
    from repro_torch.lint import runtime as rt
    from repro_torch.models.api import Model
    from repro_torch.models.layers import (materialize, param_count,
                                           tree_leaves)
    from repro_torch.optim.optimizers import AdamW
    from repro_torch.training.step import (loss_and_grads, make_eval_step,
                                           make_train_step)

    cfg = get_config(arch)
    model = Model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = materialize(model.decls(), 23, device=dev)
    opt_args = dict(lr=FULL_TRAIN_LR, warmup=warmup)
    opt = _TimedOpt(AdamW(**opt_args))
    state = opt.init(params)
    step = make_train_step(model, opt)
    src = TokenSource(cfg.vocab, s, b, seed=23)
    batches = [{"tokens": torch.as_tensor(src.batch_at(k)["tokens"],
                                          device=dev)}
               for k in range(steps + 1)]
    held = batches.pop()
    evaluate = make_eval_step(model)
    held0 = evaluate(params, held)["loss"]
    expect0 = init_loss(model, params, batches[0])
    losses, gnorms, auxes = [], [], []

    def run(ks, marks=None):
        nonlocal params, state
        for k in ks:
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            params, state, m = step(params, state, batches[k])
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            auxes.append(m.get("aux_loss", torch.zeros((), device=dev)))
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    run(range(warm))
    torch.cuda.synchronize()
    marks = []
    opt.on = True
    pulls, warned = guarded(run, range(warm, warm + timed), marks)
    opt.on = False
    torch.cuda.synchronize()
    assert not pulls and warned == 0, (arch, pulls, warned)
    run(range(warm + timed, steps))
    held1 = evaluate(params, held)["loss"]
    with rt.explicit_sync("train_metrics"):
        loss = torch.stack(losses).float().cpu().tolist()
        gn = torch.stack(gnorms).float().cpu().tolist()
        held0, held1 = float(held0), float(held1)
        # the loss is the total: CE + aux_loss_coef x the MoE's aux loss
        expect0 += cfg.aux_loss_coef * float(auxes[0])
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(timed)]
    upd_ms = [a.elapsed_time(e) for a, e in opt.marks]
    med = statistics.median(step_ms)
    flops = train_model_flops(cfg, b, s)
    tail = loss[-min(5, steps - 1):]
    assert all(math.isfinite(x) for x in loss), (arch, loss)
    assert all(math.isfinite(g) and g > 0 for g in gn), (arch, gn)
    assert abs(loss[0] - expect0) <= LOSS0_BAR, (arch, loss[0], expect0)
    assert margin is None or statistics.mean(tail) <= loss[0] - margin, (
        arch, loss)
    assert held1 <= held0 - held_margin, (arch, held0, held1)
    # one profiled step (training goes on: its update is applied)
    split = profile_split(lambda: step(params, state, batches[-1]), 1,
                          lambda name, cat: "ops")
    busy_ms, n_ops = split["ops"].get("ops", (0.0, 0))
    # remat on against off on one 1 x s batch, and where a step's time
    # goes there: the forward, the backward, the recomputation
    one = {"tokens": batches[0]["tokens"][:1]}
    plain = Model(dc.replace(cfg, remat=False))
    (_, _), g_on = loss_and_grads(model, params, one)
    (_, _), g_off = loss_and_grads(plain, params, one)
    e_remat = max(float((a.float() - w.float()).norm() / w.float().norm())
                  for a, w in zip(tree_leaves(g_on), tree_leaves(g_off)))
    assert e_remat <= REMAT_REL, (arch, e_remat)
    del g_on, g_off
    fwd_ms = event_ms(lambda: evaluate(params, one), 3)
    off_ms = event_ms(lambda: loss_and_grads(plain, params, one), 3)
    on_ms = event_ms(lambda: loss_and_grads(model, params, one), 3)
    print(f"{tag} {arch} FULL ({param_count(model.decls()) / 1e9:.3f}e9 "
          f"parameters, bf16, remat on, AdamW {opt_args}) training "
          f"on {b} x {s} tokens a step ({smi}): step {med:.3f} ms (median "
          f"of {timed}; min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{b * s * 1e3 / med:.1f} tokens/s, the optimizer update "
          f"{statistics.median(upd_ms):.3f} ms ({sum(upd_ms) / sum(step_ms):.3f}"
          f" of the timed steps), model FLOPs {flops:.4e} a step = "
          f"{flops / med / 1e9:.1f} TFLOP/s ({flops / (med * 1e-3) / PEAK_BF16:.4f}"
          f" of the {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16 dense peak), peak "
          f"memory {peak / 2**30:.2f} GiB; implicit syncs in the timed "
          f"steps {warned} (explicit pulls {pulls or 0}); losses "
          f"{' '.join(f'{x:.4f}' for x in loss)} (step 0 against its "
          f"expectation {expect0:.4f}, ln V {math.log(cfg.vocab):.4f}; the "
          f"last {len(tail)} average {statistics.mean(tail):.4f}, bar "
          f"{'none' if margin is None else f'<= step 0 - {margin}'}); a "
          f"held batch's loss {held0:.4f} before, {held1:.4f} after (bar "
          f"a fall of {held_margin}); grad norm {gn[0]:.4f} to "
          f"{gn[-1]:.4f}; "
          f"remat on against off on 1 x {s}: grads {e_remat:.3e} (bar "
          f"{REMAT_REL}); on 1 x {s} (median of 3): a forward without "
          f"autograd {fwd_ms:.3f} ms, forward and backward {off_ms:.3f} ms "
          f"without remat, {on_ms:.3f} ms with it (the backward and the "
          f"graph's recording {off_ms - fwd_ms:.3f}, remat's cost "
          f"{on_ms - off_ms:.3f}); one step under the profiler: "
          f"host enqueue "
          f"{split['host']:.3f} ms, device busy {busy_ms:.3f} ms in {n_ops} "
          f"operations, idle {split['gap']:.3f} ms of a {split['span']:.3f} "
          f"ms span (idle share {split['gap'] / split['span']:.3f})",
          flush=True)
    READINGS[f"{tag} {arch} step_ms"] = med
    del params, state, batches
    torch.cuda.empty_cache()
    return med


def phase_train(dev, smi, parts=("17a", "17b", "17c", "17d")):
    """Phase 17: LM training (`repro_torch.training`; plain PyTorch, no
    kernel of its own)."""
    import torch
    t0 = time.perf_counter()
    if "17a" in parts:
        phase_train_smoke(dev)
    if "17b" in parts:
        phase_train_launcher(dev)
    for i, row in enumerate(TRAIN_FULL):
        tag = "[17c]" if i == 0 else "[17d]"
        if tag[1:-1] in parts:
            phase_train_full(dev, smi, tag, *row)
    torch.cuda.synchronize()
    print(f"[17] phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)


# 18a: the dry run's arguments plus its peak of temporaries against the
# real step's max_memory_allocated
DRY_PEAK_BAND = (0.8, 1.25)
DRY_TRAIN = ("internlm2-1.8b", 4, 2048)
# 18b: the cells run on the fake process group, (arch, shape, multi pod)
DRY_CELLS = (("gemma-7b", "train_4k", False), ("arctic-480b", "train_4k", True))


def phase_dryrun_step(dev, smi):
    """18a: 17c's step dry run on one device (plain meta tensors) against
    one real step on the card under the same `analyze`."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.api import Model, ShapeSpec
    from repro_torch.models.config import shard_ctx_for_mesh
    from repro_torch.models.layers import materialize
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.training.step import make_train_step
    from repro_torch.configs.registry import get_config, optimizer_for

    arch, b, s = DRY_TRAIN
    cfg = get_config(arch)
    model = Model(cfg)
    shape = ShapeSpec(f"train_{s}", s, b, "train")
    t0 = time.perf_counter()
    rep = dryrun.one_device_report(arch, model, shape)
    dry_s = time.perf_counter() - t0
    pd = rep["per_device"]
    torch.cuda.empty_cache()
    params = materialize(model.decls(), 23, device=dev)
    opt = get_optimizer(optimizer_for(arch))
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(23)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                                     dtype=torch.int32, device=dev)}
    step = make_train_step(model, opt, shard_ctx_for_mesh(
        MeshShape((1, 1), ("data", "model"))))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    real = analyze(step, params, state, batch)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(0).total_memory
    ratio = pd["peak_hbm_est"] / peak
    want_flops = 6 * rep["active_params"] * b * s
    print(f"[18a] {arch} FULL train step {b} x {s} (bf16, remat, "
          f"{optimizer_for(arch)}; {smi}): dry run on one device "
          f"{dry_s:.1f} s (plain meta tensors, {rep['ops_per_device']} ops), "
          f"the real step under analyze {real_s:.1f} s ({real.ops} ops); "
          f"matmul FLOPs dry {rep['matmul_flops_per_device']:.6e} real "
          f"{real.matmul_flops:.6e}; all FLOPs dry "
          f"{rep['hlo_flops_total']:.6e} real {real.flops:.6e}; bytes dry "
          f"{rep['hlo_bytes_total']:.6e} real {real.hbm_bytes:.6e}; "
          f"model_flops {rep['model_flops']:.6e} (17c's count "
          f"{train_model_flops(cfg, b, s):.6e}); arguments "
          f"{pd['argument_bytes'] / 2**30:.3f} GiB + peak temporaries "
          f"{(pd['peak_hbm_est'] - pd['argument_bytes']) / 2**30:.3f} GiB = "
          f"{pd['peak_hbm_est'] / 2**30:.3f} GiB against the real step's "
          f"max_memory_allocated {peak / 2**30:.3f} GiB (ratio {ratio:.4f}, "
          f"band {DRY_PEAK_BAND}); the real step's peak of live outputs "
          f"{real.peak_bytes / 2**30:.3f} GiB; the card's total_memory "
          f"{total} bytes (the dry run's HBM_BYTES {dryrun.HBM_BYTES})",
          flush=True)
    assert rep["matmul_flops_per_device"] == real.matmul_flops > 0, (
        rep["matmul_flops_per_device"], real.matmul_flops)
    assert rep["model_flops"] == want_flops, (rep["model_flops"], want_flops)
    assert DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1], ratio
    READINGS["[18a] dry/real peak"] = ratio
    del params, state, batch
    torch.cuda.empty_cache()


DRY_CELL_CODE = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
for arch, shape, multi in json.loads(sys.argv[1]):
    r = run_cell(arch, shape, multi)
    print(json.dumps(r), flush=True)
"""


def start_dryrun_cells():
    """Start 18b's subprocess: `run_cell` for DRY_CELLS on the CPU, in a
    process that sees no card (the fake process group never shares a
    process with CUDA work). It runs during the kernel build; its output
    goes to temporary files. Killed at exit if it is still running."""
    import atexit
    import tempfile
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", DRY_CELL_CODE,
                             json.dumps(DRY_CELLS)], stdout=out, stderr=err,
                            text=True, env=env, cwd=ROOT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, err, time.perf_counter()


def phase_dryrun_cells(smi, started=None):
    """18b: waits for `start_dryrun_cells`' subprocess (started here
    unless given) and prints its cells."""
    from repro_torch.launch.dryrun import HBM_BYTES
    proc, out, err, t0 = started or start_dryrun_cells()
    t1 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t1
    out.seek(0)
    err.seek(0)
    text = out.read()
    assert rc == 0, err.read()[-3000:]
    reps = [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]
    assert len(reps) == len(DRY_CELLS), text[-2000:]
    for r in reps:
        assert r["status"] == "ok", r
        pd, rf = r["per_device"], r["roofline"]
        print(f"[18b] {r['arch']} {r['shape']} on {r['mesh']} ({r['chips']} "
              f"fake ranks; fits_hbm against {HBM_BYTES} bytes): dry_run_s "
              f"{r['dry_run_s']}, per device arguments "
              f"{pd['argument_bytes'] / 2**30:.3f} GiB, temporaries "
              f"{pd['temp_bytes'] / 2**30:.3f} GiB, outputs "
              f"{pd['output_bytes'] / 2**30:.3f} GiB (aliased "
              f"{pd['alias_bytes'] / 2**30:.3f}), peak "
              f"{pd['peak_hbm_est'] / 2**30:.3f} GiB, fits_hbm "
              f"{r['fits_hbm']}; roofline compute {rf['compute_s']:.4f} s, "
              f"memory {rf['memory_s']:.4f} s, collective "
              f"{rf['collective_s']:.4f} s (dominant {rf['dominant']}, useful "
              f"FLOPs {rf['useful_flops_frac']:.4f}); collectives "
              f"{ {k: (int(v['count']), v['bytes']) for k, v in r['collectives'].items()} }",
              flush=True)
    print(f"[18b] the subprocess, on the CPU, had been running "
          f"{time.perf_counter() - t0:.1f} s when phase 18 took its result "
          f"(it waited {waited:.1f} s for it)", flush=True)


def phase_dryrun(dev, smi, parts=("18a", "18b"), started=None):
    """Phase 18: the LM dry run and its cost analysis (plain PyTorch, no
    kernel of its own). `started`: 18b's subprocess, if started earlier."""
    t0 = time.perf_counter()
    if "18a" in parts:
        phase_dryrun_step(dev, smi)
    if "18b" in parts:
        phase_dryrun_cells(smi, started)
    print(f"[18] phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)


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
    # 18b runs on the CPU during the build, where it times nothing (later
    # it would take a core from the host-bound LM phases 16 and 17)
    dry_cells = start_dryrun_cells()
    t0 = time.perf_counter()
    _build.build()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s "
          f"{ {k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()} }",
          flush=True)
    for line in _build.BUILD_LOG.get("batch_cluster", "").splitlines():
        if "Used" in line or "spill" in line and " 0 bytes" not in line:
            print(f"    batch_cluster: {line.strip()}")
    usage = ptxas_usage(_build.BUILD_LOG.get("batch_cluster_field", ""))
    for name, (regs, st, ld) in sorted(usage.items()):
        print(f"    batch_cluster_field {name}: {regs} registers, spill "
              f"stores {st} bytes, spill loads {ld} bytes", flush=True)
    print_grid_usage(ptxas_usage(
        _build.BUILD_LOG.get("batch_cluster_field_grid", "")))
    usage = ptxas_usage(_build.BUILD_LOG.get("modified_charges", ""))
    if usage:
        spills = {k: v for k, v in usage.items() if v[1] or v[2]}
        print(f"    modified_charges: {len(usage)} kernels, "
              f"{min(v[0] for v in usage.values())}-"
              f"{max(v[0] for v in usage.values())} registers, spills "
              f"{spills or 'none'}", flush=True)
    # the main path's variant: f32, Coulomb, free space, no Kahan, diff r2
    loop = sass_inner_loop(_build.library_path("batch_cluster"),
                           "batch_cluster_kernelIfLi0ELb0ELb0ELb0E")
    print("[1] batch_cluster f32 Coulomb inner loop (SASS): " + (
        f"{loop[0]} instructions for {loop[1]} pairs, "
        f"{loop[0] / loop[1]:.2f} per pair" if loop else "not measured "
        "(no cuobjdump)"), flush=True)
    loop = sass_inner_loop(_build.library_path("batch_cluster_field"),
                           "field_kernelIfLi0ELb0ELb0E")
    print("[1] batch_cluster_field f32 Coulomb inner loop (SASS): " + (
        f"{loop[0]} instructions for {loop[1]} pairs, "
        f"{loop[0] / loop[1]:.2f} per pair" if loop else "not measured "
        "(no cuobjdump)"), flush=True)
    # the grid kernel at the main path's n+1 = 9: its plane loop, whose
    # unchecked sweep unrolls the plane's rows for each of a lane's targets
    loop = sass_inner_loop(_build.library_path("batch_cluster_field_grid"),
                           "grid_field_kernelIfLi9ELi0EE")
    print("[1] batch_cluster_field_grid f32 Coulomb n+1=9 plane loop (SASS): "
          + (f"{loop[0]} instructions for {loop[1]} pairs, "
             f"{loop[0] / loop[1]:.2f} per pair" if loop else "not measured "
             "(no cuobjdump)"), flush=True)

    laps = [t_start]

    def lap(name):
        """The time since the previous lap: where the script's time goes."""
        now = time.perf_counter()
        print(f"[t] {name}: {now - laps[-1]:.1f} s (at {now - t_start:.1f} "
              f"s)", flush=True)
        laps.append(now)

    lap("1 (build)")
    phase_batch_cluster(dev)
    phase_field(dev)
    phase_field_grid(dev)
    phase_modified_charges(dev)
    lap("2, 2f, 2g, 3")
    plan, x, q, report = phase_main(dev, smi)
    lap("4")
    report += phase_forces(dev, plan, x, q, smi)
    lap("4f")
    phase_sheet(dev, smi)
    phase_yukawa(dev, plan, x, q)
    lap("4s, 5")
    phase_sharded(dev, smi, x, q, plan)
    lap("13a")
    report.append(phase_differentiable(dev, smi, plan, x, q))
    lap("14")
    phase_periodic(dev)
    md_launches, *host_ref, md_sim = phase_md(dev)
    for entry in report:     # the field kernels' launches are the MD run's
        if entry["name"].startswith("batch_cluster_field"):
            entry["launches"] = md_launches[entry["name"]]
    phase_md(dev, "[8d]", "device", host_ref=host_ref)
    phase_md(dev, "[8a]", "device", async_replan=True,
             host_ref=host_ref)
    phase_md_periodic(dev)
    lap("6, 8, 8d, 8a, 9")
    dplan = phase_device_plan(dev, smi, x, q)
    phase_hierarchical(dev, x, q, next(e["ms"] for e in report
                                       if e["name"] == "modified_charges"))
    lap("10, 11")
    phase_serve_ensemble(dev, smi)
    phase_serve_kappa_scan(dev)
    serve = phase_serve_frontend(dev)
    phase_serve_md(dev)
    lap("12")
    phase_sharded_md(dev)
    lap("13b")
    phase_checking_tools(dev, smi, plan, x, q, md_sim, dplan, serve)
    lap("15")
    del plan, md_sim, dplan, serve, x, q
    torch.cuda.empty_cache()
    phase_lm_smoke(dev)
    phase_lm_full(dev, smi)
    phase_lm_full_archs(dev, smi)
    lap("16")
    torch.cuda.empty_cache()
    phase_train(dev, smi)
    lap("17")
    torch.cuda.empty_cache()
    phase_dryrun(dev, smi, started=dry_cells)
    lap("18")
    print(f"[7] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

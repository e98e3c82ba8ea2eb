"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test asks the `cuda_device` fixture for the device
and skips where there is none (as in CPU-only containers). The full
sweep at the main path's shapes is `python3 chip_smoke.py`."""
import numpy as np
import pytest
import torch

from repro_torch.core.potentials import coulomb, yukawa
from repro_torch.core.space import FREE, PeriodicBox
from repro_torch.kernels import batch_cluster as bcm
from repro_torch.kernels import modified_charges as mcm
from repro_torch.kernels import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_batch_cluster_kernel_matches_plain(cuda_device, dtype, periodic,
                                            kahan):
    rng = np.random.default_rng(0)
    B, S, NB, C, m = 4, 6, 200, 9, 300        # ragged NB and m
    qlo = -1.0 if dtype == torch.float32 else 0.0
    tgt = rng.uniform(-1, 1, (B, NB, 3))
    src = rng.uniform(-1, 1, (C, m, 3))
    tgt[-1, 0] = src[0, 0]                     # coincident pair
    idx = rng.integers(-1, C, (B, S))
    idx[:, 2] = -1                             # interior sentinels
    idx[0] = -1                                # an all-empty row
    idx[-1, 0] = 0
    t = [torch.as_tensor(a, dtype=dtype, device=cuda_device)
         for a in (tgt, src, rng.uniform(qlo, 1, (C, m)))]
    it = torch.as_tensor(idx, dtype=torch.int32, device=cuda_device)
    space = PeriodicBox((1.5, 2.0, 1.7)) if periodic else FREE
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-12, 0.0)
    for kern in (coulomb(), yukawa(0.5), yukawa(1.7)):
        before = bcm.LAUNCHES
        got = ops.batch_cluster_eval(it, *t, kernel=kern, space=space,
                                     kahan=kahan)
        assert bcm.LAUNCHES == before + 1
        want = ops.batch_cluster_eval(it, *t, kernel=kern, space=space,
                                      kahan=kahan, backend="torch")
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        assert (got[0] == 0).all() and torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_batch_cluster_kernel_counts_match_plain(cuda_device, dtype,
                                                 periodic, kahan):
    """Target and source counts: ragged, a row and a cluster with count 0,
    counts off the unroll and the 128-target tile; phi is exactly 0 on
    padded target slots, and the real slots match the plain version."""
    rng = np.random.default_rng(1)
    B, S, NB, C, m = 5, 7, 300, 9, 301
    qlo = -1.0 if dtype == torch.float32 else 0.0
    tgt = rng.uniform(-1, 1, (B, NB, 3))
    src = rng.uniform(-1, 1, (C, m, 3))
    tgt[1, 0] = src[0, 0]                      # coincident pair
    idx = rng.integers(-1, C, (B, S))
    idx[:, 3] = -1                             # interior sentinels
    idx[1, 0] = 0
    idx[2, 1] = C - 1                          # the empty cluster
    tc = np.array([0, NB, 129, 7, 250], dtype=np.int32)
    sc = rng.integers(1, m + 1, C).astype(np.int32)
    sc[0], sc[1], sc[C - 1] = m, 5, 0
    dev = cuda_device
    t = [torch.as_tensor(a, dtype=dtype, device=dev)
         for a in (tgt, src, rng.uniform(qlo, 1, (C, m)))]
    it = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    counts = dict(tgt_count=torch.as_tensor(tc, device=dev),
                  src_count=torch.as_tensor(sc, device=dev))
    space = PeriodicBox((1.5, 2.0, 1.7)) if periodic else FREE
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-12, 0.0)
    lib = bcm._build.load("batch_cluster", bcm._SIGNATURES)
    assert lib.bc_geometry(0) == bcm._TARGETS_PER_BLOCK
    assert lib.bc_geometry(1) == bcm._SOURCE_UNROLL
    pad = torch.arange(NB, device=dev)[None] >= counts["tgt_count"][:, None]
    for kern in (coulomb(), yukawa(0.5)):
        got = ops.batch_cluster_eval(it, *t, kernel=kern, space=space,
                                     kahan=kahan, **counts)
        want = ops.batch_cluster_eval(it, *t, kernel=kern, space=space,
                                      kahan=kahan, backend="torch", **counts)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        assert (got[pad] == 0).all() and torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [1, 4, 8, 14])
def test_modified_charges_kernel_matches_plain(cuda_device, dtype, degree):
    rng = np.random.default_rng(degree)
    from repro_torch.core import cheby
    C, m = 5, 700
    lo = torch.as_tensor(rng.uniform(-1, 0, (C, 3)), dtype=dtype,
                         device=cuda_device)
    hi = lo + 0.5
    pts = lo[:, None] + 0.5 * torch.as_tensor(
        rng.uniform(0, 1, (C, m, 3)), dtype=dtype, device=cuda_device)
    grid = cheby.cluster_grid(lo, hi, degree)
    k = min(100, grid.shape[1])
    pts[:, :k] = grid[:, :k]                   # exact hits
    q = torch.as_tensor(rng.uniform(-1, 1, (C, m)), dtype=dtype,
                        device=cuda_device)
    pts[:, -20:] = (0.5 * (lo + hi))[:, None]  # center padding
    q[:, -20:] = 0
    before = mcm.LAUNCHES
    got = ops.modified_charges(pts, q, lo, hi, degree=degree)
    # the chunk kernel and the per-node sum
    assert mcm.LAUNCHES == before + 2
    want = ops.modified_charges(pts, q, lo, hi, degree=degree,
                                backend="torch")
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=3e-3, atol=3e-4)
    else:
        torch.testing.assert_close(got, want, rtol=1e-10,
                                   atol=1e-12 * want.abs().max().item())


def ranged_case(rng, dtype, degree, dev, tile):
    """Ragged node ranges for the ranged kernel: counts 0 and 1, at the
    kernel's `tile` and at the chunk size, each node's points in its own
    box with some ON its Chebyshev nodes (exact hits), and a last node
    that spans all of them, as a parent level does."""
    from repro_torch.core import cheby
    p = mcm.CHUNK
    counts = [0, 1, tile - 1, tile, tile + 1, p - 1, p, p + 1, 3 * p + 5,
              0, 37]
    def dev_t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    lo = dev_t(rng.uniform(-1, 0, (len(counts), 3)))
    hi = lo + dev_t(rng.uniform(0.3, 1, (len(counts), 3)))
    grids = cheby.cluster_grid(lo, hi, degree)   # in the working dtype
    parts = []
    for i, c in enumerate(counts):
        x = lo[i] + (hi[i] - lo[i]) * dev_t(rng.uniform(0, 1, (c, 3)))
        k = min(c // 3, grids.shape[1])
        x[:k] = grids[i, :k]                     # exact hits
        parts.append(x)
    pts = torch.cat(parts)
    n = pts.shape[0]
    # the last node spans all the others
    start = np.append(np.concatenate([[0], np.cumsum(counts)[:-1]]), 0)
    lo = torch.cat([lo, pts.amin(0, keepdim=True)])
    hi = torch.cat([hi, pts.amax(0, keepdim=True)])
    chunks, ptr = mcm.chunk_table(start, counts + [n])
    return (pts, dev_t(rng.uniform(-1, 1, n)),
            torch.as_tensor(chunks, device=dev),
            torch.as_tensor(ptr, device=dev), lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [1, 4, 8, 14])
def test_modified_charges_ranged_kernel_matches_plain(cuda_device, dtype,
                                                      degree):
    """The ranged kernel against its plain version on ragged ranges: two
    launches a call, bitwise equal calls, 0 on nodes without particles."""
    lib = mcm._build.load("modified_charges", mcm._SIGNATURES)
    tile = lib.mc_tile(dtype.itemsize, degree + 1)
    args = ranged_case(np.random.default_rng(100 + degree), dtype, degree,
                       cuda_device, tile)
    before = mcm.LAUNCHES
    got = ops.modified_charges_ranged(*args, degree=degree)
    assert mcm.LAUNCHES == before + 2
    again = ops.modified_charges_ranged(*args, degree=degree)
    assert torch.equal(got, again)
    want = ops.modified_charges_ranged(*args, degree=degree,
                                       backend="torch")
    assert (got[0] == 0).all() and (got[9] == 0).all()
    scale = want.abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=3e-3, atol=3e-4 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=1e-10,
                                   atol=1e-12 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_field_kernel_matches_plain(cuda_device, dtype, periodic, kahan):
    """The field kernel against its plain version with counts, sentinels
    and exact hits: phi as the potential kernel's tolerance, each gradient
    component with its atol times max|grad| (signed terms) and within
    1e-5 (f32) or 1e-13 (f64) times its own sum of the terms'
    magnitudes; exact hits give 0 in all four outputs; its phi is the
    potential kernel's."""
    rng = np.random.default_rng(2)
    B, S, NB, C, m = 5, 7, 300, 9, 301
    qlo = -1.0 if dtype == torch.float32 else 0.0
    tgt = rng.uniform(-1, 1, (B, NB, 3))
    src = rng.uniform(-1, 1, (C, m, 3))
    tgt[1, :3] = src[0, :3]                    # exact hits
    idx = rng.integers(-1, C, (B, S))
    idx[:, 3] = -1
    idx[1, 0] = 0
    dev = cuda_device
    t = [torch.as_tensor(a, dtype=dtype, device=dev)
         for a in (tgt, src, rng.uniform(qlo, 1, (C, m)))]
    it = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    tc = torch.as_tensor([0, NB, 129, 7, 250], dtype=torch.int32, device=dev)
    sc = torch.as_tensor(rng.integers(1, m + 1, C), dtype=torch.int32,
                         device=dev)
    sc[0] = m
    space = PeriodicBox((1.5, 2.0, 1.7)) if periodic else FREE
    rtol = 2e-4 if dtype == torch.float32 else 1e-12
    for kern in (coulomb(), yukawa(0.5)):
        kw = dict(kernel=kern, space=space, kahan=kahan, tgt_count=tc,
                  src_count=sc)
        before = bcm.FIELD_LAUNCHES
        got = ops.batch_cluster_field(it, *t, **kw)
        assert bcm.FIELD_LAUNCHES == before + 1
        want = ops.batch_cluster_field(it, *t, backend="torch", **kw)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(
            got[..., 0], want[..., 0], rtol=rtol,
            atol=2e-4 if dtype == torch.float32 else 0.0)
        gmax = want[..., 1:].abs().max().item()
        torch.testing.assert_close(got[..., 1:], want[..., 1:], rtol=rtol,
                                   atol=rtol * gmax)
        # and each gradient entry within k times its own sum of the
        # terms' magnitudes (an entry that cancels keeps their rounding)
        mag = bcm.batch_cluster_field_plain(it, *t, magnitude=True, **kw)
        k = 1e-5 if dtype == torch.float32 else 1e-13
        assert ((got - want)[..., 1:].abs() <= k * mag[..., 1:]).all()
        pad = torch.arange(NB, device=dev)[None] >= tc[:, None]
        assert (got[pad] == 0).all()
        phi = ops.batch_cluster_eval(it, *t, **kw)
        torch.testing.assert_close(got[..., 0], phi, rtol=1e-6, atol=1e-6)
    x = t[0][:1, :1].clone()
    one = torch.ones((1, 1), dtype=dtype, device=dev)
    lone = ops.batch_cluster_field(torch.zeros((1, 1), dtype=torch.int32,
                                               device=dev), x, x.clone(),
                                   one, kernel=coulomb(), space=space)
    assert (lone == 0).all()


def _fold_ties(length, dtype=np.float32):
    """Displacements d near a minimum-image tie (d / L near a half-integer)
    where rint(d * (1/L)) and rint(d / L) pick different images."""
    L = dtype(length)
    inv = dtype(1) / L
    out = []
    for h in (0.5, -0.5, 1.5):
        lo = hi = dtype(h * float(L))
        ds = [lo]
        for _ in range(16):
            lo = np.nextafter(lo, dtype(-9))
            hi = np.nextafter(hi, dtype(9))
            ds += [lo, hi]
        ds = np.array(ds, dtype)
        out += list(ds[np.rint(ds * inv) != np.rint(ds / L)])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1.7, 1.7778428792953491])
def test_field_kernel_folds_ties_as_reference(cuda_device, length):
    """At a minimum-image tie the kernel picks the reference's image,
    round(d / L) half to even, so each gradient component has the plain
    version's sign (f32: d * (1/L) rounds across the tie for these d)."""
    ties = _fold_ties(length)
    assert ties, "no tie displacement for this length"
    tgt = np.zeros((1, len(ties), 3), np.float32)
    tgt[0, :, 0] = ties
    tgt[0, :, 1:] = (0.1, 0.2)
    dev = cuda_device
    t = [torch.as_tensor(a, device=dev) for a in (
        tgt, np.zeros((1, 1, 3), np.float32), np.ones((1, 1), np.float32))]
    it = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    kw = dict(kernel=coulomb(), space=PeriodicBox((length, 7.0, 7.0)))
    got = ops.batch_cluster_field(it, *t, **kw)
    want = ops.batch_cluster_field(it, *t, backend="torch", **kw)
    assert torch.equal(torch.sign(got), torch.sign(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_simulation_on_the_card(cuda_device):
    """A short MD run through the CUDA kernels against the same run on the
    card's plain versions (f32: positions within 1e-5 of the box). The
    Verlet skin floors the refit budget at skin/2, so steps refit."""
    from repro_torch.core.api import TreecodeConfig, TreecodeSolver
    from repro_torch.dynamics import Simulation

    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    q = (0.05 * rng.uniform(-1, 1, 20000)).astype(np.float32)
    runs = {}
    for backend in ("cuda", "torch"):
        cfg = TreecodeConfig(theta=0.7, degree=5, leaf_size=256,
                             skin=0.01, backend=backend)
        plan = TreecodeSolver(cfg).plan(x, capacities="auto")
        before = (bcm.FIELD_LAUNCHES, bcm.GRID_FIELD_LAUNCHES)
        sim = Simulation(plan, q, dt=2e-4, refit_interval=4)
        sim.run(6, record_every=3)
        s = sim.stats()
        assert s["retraces"] == 0 and s["capacity_growths"] == 0
        assert s["rebuilds"] >= 1 and s["refits"] >= 3
        # 7 force evaluations: one field and one grid field launch each
        launched = (bcm.FIELD_LAUNCHES - before[0],
                    bcm.GRID_FIELD_LAUNCHES - before[1])
        assert launched == ((7, 7) if backend == "cuda" else (0, 0))
        assert torch.isfinite(sim.state.x).all()
        runs[backend] = sim
    dx = (runs["cuda"].state.x - runs["torch"].state.x).abs().max().item()
    assert dx < 1e-5, dx
    assert runs["cuda"].log.drift() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [15, 24])
def test_degree_above_14_runs_on_the_card(cuda_device, dtype, degree):
    """Degrees past the templates (n+1 >= 16) run the runtime-degree
    kernels, one launch each: the forward modified charges on W = 3
    stacked systems of ragged ranges with exact hits, the transpose on
    their two-level tile table, and the grid field kernel on W = 3
    systems with exact hits, free and periodic, Kahan off and on, with
    target counts; each against its plain version at the tolerances of
    the templated tests above (the gradient per entry to 1e-5 (f32) or
    1e-13 (f64) times its sum of the terms' magnitudes)."""
    from repro_torch.core import cheby
    rng = np.random.default_rng(degree)
    dev, n1, w = cuda_device, degree + 1, 3
    f32 = dtype == torch.float32
    rtol, floor = (3e-3, 3e-4) if f32 else (1e-10, 1e-12)
    lib = mcm._build.load("modified_charges", mcm._SIGNATURES)
    pts, q, chunks, ptr, lo, hi = ranged_case(
        rng, dtype, degree, dev, lib.mc_tile(dtype.itemsize, n1))

    def stack(t):
        return torch.stack([t] * w)

    qs = torch.stack([q] + [torch.as_tensor(rng.uniform(-1, 1, q.shape),
                                            dtype=dtype, device=dev)
                            for _ in range(w - 1)])
    args = (stack(pts), qs, stack(chunks), stack(ptr), stack(lo), stack(hi))
    before = (mcm.LAUNCHES, mcm.RUNTIME_LAUNCHES)
    got = ops.modified_charges_ranged(*args, degree=degree)
    assert (mcm.LAUNCHES - before[0], mcm.RUNTIME_LAUNCHES - before[1]) == (
        2, 1)
    want = ops.modified_charges_ranged(*args, degree=degree, backend="torch")
    assert (got[:, 0] == 0).all() and (got[:, 9] == 0).all()
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=floor * want.abs().max().item())

    # the transpose: every node a leaf under the last, which spans them
    m = lo.shape[0]
    parent = torch.full((m,), m - 1, device=dev)
    parent[-1] = -1
    tiles, chain = mcm.tile_table(chunks, parent, 2, pts.shape[0])
    qhat_bar = torch.as_tensor(rng.uniform(-1, 1, (m, n1 ** 3)), dtype=dtype,
                               device=dev)
    targs = (pts, qhat_bar, tiles, chain, lo, hi)
    before = (mcm.TRANSPOSE_LAUNCHES, mcm.TRANSPOSE_RUNTIME_LAUNCHES)
    got = ops.modified_charges_transpose_ranged(*targs, degree=degree)
    assert (mcm.TRANSPOSE_LAUNCHES - before[0],
            mcm.TRANSPOSE_RUNTIME_LAUNCHES - before[1]) == (1, 1)
    want = ops.modified_charges_transpose_ranged(*targs, degree=degree,
                                                 backend="torch")
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=floor * want.abs().max().item())

    # the grid field kernel
    box = PeriodicBox((1.5, 2.0, 1.7), origin=(-0.75, -1.0, -0.85))
    b, s, nb, c = 4, 6, 70, 5
    frtol, fatol = (2e-4, 2e-4) if f32 else (1e-12, 0.0)
    gk = 1e-5 if f32 else 1e-13
    for space, kahan, kern in ((FREE, False, coulomb()),
                               (box, True, yukawa(0.5))):
        lo_t = torch.as_tensor(rng.uniform(-1, 0.5, (w, c, 3)), dtype=dtype,
                               device=dev)
        hi_t = lo_t + torch.as_tensor(rng.uniform(0.1, 0.5, (w, c, 3)),
                                      dtype=dtype, device=dev)
        nodes = ops._cluster_nodes(lo_t, hi_t, degree).contiguous()
        grid = cheby.cluster_grid(lo_t, hi_t, degree)
        qh = torch.as_tensor(rng.uniform(-1.0 if f32 else 0.0, 1,
                                         (w, c, n1 ** 3)),
                             dtype=dtype, device=dev)
        tgt = torch.as_tensor(rng.uniform(-1, 1, (w, b, nb, 3)), dtype=dtype,
                              device=dev)
        tgt[:, -1, :3] = grid[:, 0, [0, n1 ** 3 // 2, n1 ** 3 - 1]]  # hits
        idx = rng.integers(-1, c, (w, b, s))
        idx[:, :, s // 2] = -1
        idx[:, -1, 0] = 0
        tc = rng.integers(0, nb + 1, (w, b))
        tc[:, -1] = nb
        kw = dict(kernel=kern, space=space, kahan=kahan,
                  tgt_count=torch.as_tensor(tc, dtype=torch.int32,
                                            device=dev))
        gargs = (torch.as_tensor(idx, dtype=torch.int32, device=dev), tgt,
                 nodes, qh)
        before = (bcm.GRID_FIELD_LAUNCHES, bcm.GRID_FIELD_RUNTIME_LAUNCHES)
        got = ops.batch_cluster_field_grid(*gargs, **kw)
        assert (bcm.GRID_FIELD_LAUNCHES - before[0],
                bcm.GRID_FIELD_RUNTIME_LAUNCHES - before[1]) == (1, 1)
        want = ops.batch_cluster_field_grid(*gargs, backend="torch", **kw)
        mag = bcm.batch_cluster_field_grid_plain(*gargs, magnitude=True, **kw)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got[..., 0], want[..., 0], rtol=frtol,
                                   atol=fatol)
        assert ((got[..., 1:] - want[..., 1:]).abs()
                <= gk * mag[..., 1:]).all()
        pad = torch.arange(nb, device=dev) >= kw["tgt_count"][..., None]
        assert (got[pad] == 0).all()


@pytest.mark.cuda
def test_device_build_on_the_card_equals_the_cpu_build(cuda_device):
    """The device tree build on the card gives the CPU build's plan (f64,
    so no MAC margin sits within the rounding of the two devices' sums):
    every integer array equal, the boxes too (min and max only); a replan
    is bitwise the same, and `replan_async` dispatches without a host
    sync and gives the same plan."""
    from repro_torch.core.api import TreecodeConfig, TreecodeSolver

    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (30000, 3))
    cfg = TreecodeConfig(theta=0.7, degree=4, leaf_size=64, skin=0.01,
                         build_backend="device")
    gpu = TreecodeSolver(cfg).plan(x)
    cpu = TreecodeSolver(cfg, device="cpu").plan(x)
    assert gpu.capacities == cpu.capacities
    for k, v in cpu.arrays.items():
        for g, c in zip(gpu.arrays[k] if isinstance(v, tuple) else (
                gpu.arrays[k],), v if isinstance(v, tuple) else (v,)):
            assert torch.equal(g.cpu(), c), k
    xd = torch.as_tensor(x, device=cuda_device)
    again = gpu.replan(xd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = gpu.replan_async(xd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    shadow, wait_ms, grew = pending.finalize()
    assert not grew and wait_ms >= 0.0
    for p in (again, shadow):
        for k, v in gpu.arrays.items():
            if not isinstance(v, tuple):
                assert torch.equal(p.arrays[k], v), k


@pytest.mark.cuda
def test_sparse_device_build_on_the_card_equals_the_cpu_build(cuda_device):
    """The hybrid sparse levels of the device build (depth 6 over leaves
    of 4: two sparse source levels and one target level, the searchsorted
    and scatter spans `tests/test_torch_devtree.py` holds against the
    reference on the CPU) give the CPU's plan on the card, f64: every
    array equal; a budgeted replan is bitwise the same, and its
    dispatch makes no host sync."""
    from repro_torch.devtree import build as tbuild

    x = np.random.default_rng(5).uniform(-1, 1, (1500, 3))
    kw = dict(theta=0.7, degree=2, leaf_size=4, batch_size=4, skin=0.02,
              depth=6, batch_depth=5)
    plans = {}
    for where in ("cpu", cuda_device):
        t = torch.as_tensor(x, device=where)
        plans[str(where)] = tbuild.prepare_plan_device(t, t, **kw)
    cpu, gpu = plans["cpu"], plans[str(cuda_device)]
    assert len(gpu.capacities.sparse_rows) == 2
    assert len(gpu.capacities.batch_sparse_rows) == 1
    assert gpu.capacities == cpu.capacities
    for k, v in cpu.arrays.items():
        for g, c in zip(gpu.arrays[k] if isinstance(v, tuple) else (
                gpu.arrays[k],), v if isinstance(v, tuple) else (v,)):
            assert torch.equal(g.cpu(), c), k
    xd = torch.as_tensor(x, device=cuda_device)
    budget = dict(kw, capacities=gpu.capacities,
                  pair_caps=gpu.dev["pair_caps"])
    again = tbuild.prepare_plan_device(xd, xd, **budget)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = tbuild.dispatch_plan_device(xd, xd, **budget)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    shadow, wait_ms, grew = pending.finalize()
    assert not grew and wait_ms >= 0.0
    for p in (again, shadow):
        for k, v in gpu.arrays.items():
            if not isinstance(v, tuple):
                assert torch.equal(p.arrays[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_systems_axis_kernels_match_plain(cuda_device, dtype):
    """The four kernels on stacked operands (W = 3: ragged per-system
    counts, per-system Yukawa kappas, a system of zero charges, a
    scratch batch row of count 0) against their plain versions."""
    rng = np.random.default_rng(9)
    dev = cuda_device
    W, B, S, NB, C, m, degree = 3, 5, 6, 150, 7, 200, 4
    n1 = degree + 1
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32,  # noqa: E731
                                    device=dev)
    idx = i32(rng.integers(-1, C, (W, B, S)))
    tgt, src = t(rng.uniform(-1, 1, (W, B, NB, 3))), t(rng.uniform(
        -1, 1, (W, C, m, 3)))
    q = t(rng.uniform(0 if dtype == torch.float64 else -1, 1, (W, C, m)))
    q[1] = 0.0
    tc, sc = i32(rng.integers(0, NB + 1, (W, B))), i32(
        rng.integers(0, m + 1, (W, C)))
    tc[:, -1] = 0
    kappa = t([0.5, 1.1, 2.0])
    lo, hi = t(rng.uniform(-1, -0.3, (W, C, 3))), t(rng.uniform(
        0.3, 1, (W, C, 3)))
    nodes = ops._cluster_nodes(lo, hi, degree)
    qhat = t(rng.uniform(-1, 1, (W, C, n1 ** 3)))
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-12, 1e-12)
    kern = yukawa()
    for space in (FREE, PeriodicBox((2.0, 2.0, 2.0))):
        kw = dict(kernel=kern, space=space, tgt_count=tc)
        cases = {
            "eval": (ops.batch_cluster_eval, (idx, tgt, src, q),
                     dict(src_count=sc)),
            "field": (ops.batch_cluster_field, (idx, tgt, src, q),
                      dict(src_count=sc)),
            "grid": (ops.batch_cluster_field_grid, (idx, tgt, nodes, qhat),
                     {}),
        }
        for name, (fn, args, extra) in cases.items():
            got = fn(*args, (kappa,), backend="cuda", **kw, **extra)
            want = fn(*args, (kappa,), backend="torch", **kw, **extra)
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                       msg=name)
            assert (got[:, -1] == 0).all(), name
    chunks = np.zeros((W, 4, 3), np.int32)
    ptr = np.zeros((W, C + 1), np.int32)
    for w in range(W):     # system w: node w holds particles [0, 60 w + 9)
        tab, p = mcm.chunk_table(np.zeros(C, np.int64),
                                 np.where(np.arange(C) == w, 60 * w + 9, 0),
                                 chunk=64)
        chunks[w, :len(tab)], ptr[w] = tab, p
        chunks[w, len(tab):] = (C - 1, 0, 0)
    pts = t(rng.uniform(-1, 1, (W, m, 3)))
    qq = t(rng.uniform(-1, 1, (W, m)))
    lo1, hi1 = t(np.full((W, C, 3), -1.0)), t(np.full((W, C, 3), 1.0))
    args = (pts, qq, i32(chunks), i32(ptr), lo1, hi1)
    got = ops.modified_charges_ranged(*args, degree=degree, backend="cuda")
    want = ops.modified_charges_ranged(*args, degree=degree, backend="torch")
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=3e-3 if dtype == torch.float32
                               else 1e-10, atol=3e-4 * scale)


@pytest.mark.cuda
def test_ensemble_runs_one_launch_per_lane(cuda_device):
    """An EnsemblePlan of W = 4 systems on the card: each execute is two
    batch-cluster and two modified-charge launches, each force call one
    field and one grid field launch, whatever W is; results within f32
    rounding of the plain versions on the card."""
    from repro_torch.core.api import TreecodeConfig
    from repro_torch.serve import EnsemblePlan

    rng = np.random.default_rng(10)
    xs = [rng.uniform(-1, 1, (n, 3)).astype(np.float32)
          for n in (3000, 5000, 4000, 2500)]
    qs = [rng.uniform(-1, 1, len(x)).astype(np.float32) for x in xs]
    out = {}
    for backend in ("cuda", "torch"):
        cfg = TreecodeConfig(theta=0.7, degree=5, leaf_size=200,
                             kernel="yukawa", backend=backend)
        plan = EnsemblePlan.build(cfg, xs)
        params = [{"kappa": k} for k in (0.5, 1.0, 1.5, 2.0)]
        before = (bcm.LAUNCHES, mcm.LAUNCHES, bcm.FIELD_LAUNCHES,
                  bcm.GRID_FIELD_LAUNCHES)
        phi = plan.execute(qs, kernel_params=params)
        phi2, F = plan.potential_and_forces(qs, kernel_params=params)
        launched = tuple(a - b for a, b in zip(
            (bcm.LAUNCHES, mcm.LAUNCHES, bcm.FIELD_LAUNCHES,
             bcm.GRID_FIELD_LAUNCHES), before))
        assert launched == ((2, 4, 1, 1) if backend == "cuda"
                            else (0, 0, 0, 0)), launched
        out[backend] = (phi, F)
    for a, b in zip(out["cuda"], out["torch"]):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err < 1e-4, err


@pytest.mark.cuda
def test_sharded_plan_on_the_card(cuda_device):
    """A P = 4 sharded plan stacked on the card against the same plan on
    the CPU (f64, the plain versions there): equal integer arrays, phi and
    forces at rtol 1e-10 with an absolute floor of 1e-12 times the
    largest |value|. Each execute makes four batch-cluster launches (the
    local, remote and halo lanes) and two modified-charge launches, each
    force call two field and two grid field launches."""
    from repro_torch.core.api import TreecodeConfig, TreecodeSolver

    rng = np.random.default_rng(18)
    x = rng.uniform(-1, 1, (12000, 3))
    q = rng.uniform(-1, 1, 12000)
    cfg = TreecodeConfig(theta=0.7, degree=4, leaf_size=200, skin=0.01)
    card = TreecodeSolver(cfg).plan(x, nranks=4)
    host = TreecodeSolver(cfg, device="cpu").plan(x, nranks=4)
    for k, v in host.arrays.items():
        if not v.is_floating_point():
            assert torch.equal(card.arrays[k].cpu(), v), k
    before = (bcm.LAUNCHES, mcm.LAUNCHES, bcm.FIELD_LAUNCHES,
              bcm.GRID_FIELD_LAUNCHES)
    phi = card.execute(q)
    fphi, F = card.potential_and_forces(q)
    launched = tuple(a - b for a, b in zip(
        (bcm.LAUNCHES, mcm.LAUNCHES, bcm.FIELD_LAUNCHES,
         bcm.GRID_FIELD_LAUNCHES), before))
    assert launched == (4, 4, 2, 2), launched
    hphi, (hfphi, hF) = host.execute(q), host.potential_and_forces(q)
    for got, want in ((phi, hphi), (fphi, hfphi), (F, hF)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-10,
                                   atol=1e-12 * want.abs().max().item())

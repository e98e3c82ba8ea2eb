"""The transposed pass's pieces: lists, kernels' transposes, no fallback.

- `eval.transposed_lists`: every valid (batch, cluster) pair of a -1-padded
  list appears exactly once in its cluster's row, batches ascending,
  -1 after them, with the counts.
- `modified_charges_transpose_ranged_plain` over `tile_table`'s tiles
  against `torch.autograd.grad` of `modified_charges_ranged_plain` (exact
  hits on the nodes, nodes with no particle, three levels with leaves at
  two depths), f64 rtol 1e-12 with a floor of 1e-14 max|want| (the same
  sums in another order).
- The hierarchical precompute's transpose against autograd of
  `compute_qhat_hierarchical`, and the direct one's, on a host plan and
  on a device-built one (f64, the same bar).
- `tile_table` on a host plan, a device-built plan and a point-budgeted
  one: every chain lists root first exactly the nodes whose range holds
  its tile, one per level, -1 past the leaf; the tiles cover every
  particle once; over the leaves' chunk table every chain is one leaf.
- The batch-cluster kernel's plain version with the roles swapped is the
  transpose of the forward: <u, B(q)> = <B^T(u), q> to 1e-13 relative in
  f64, free and periodic, Coulomb and Yukawa, the matmul r^2, with counts.
- On the card (marked `cuda`, skipped without one): the transposed
  modified-charge kernel against its plain version (f32 rtol 3e-3 / atol
  3e-4 max|want|, f64 1e-10 / 1e-12 max|want|, the forward's bars in
  `chip_smoke.py`), one launch a call, bitwise equal on a second call,
  on the three-level case and on a point-budgeted plan; the CUDA backward of
  `differentiable_execute` with every plain version patched to raise
  (no fallback), against the CPU's at f64 rtol 1e-10."""
import numpy as np
import pytest
import torch

from repro_torch.core import cheby
from repro_torch.core import eval as ev
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.potentials import coulomb, yukawa
from repro_torch.core.space import FREE, PeriodicBox
from repro_torch.devtree import build as tbuild
from repro_torch.kernels import batch_cluster as bcm
from repro_torch.kernels import modified_charges as mcm
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want, rtol, floor):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=floor * want.abs().max().item())


@pytest.mark.parametrize("seed,b,s,rows", [(0, 37, 9, 23), (1, 5, 40, 3),
                                           (2, 64, 1, 100)])
def test_transposed_lists_hold_every_pair_once(seed, b, s, rows):
    r = np.random.default_rng(seed)
    idx = r.integers(-1, rows, (b, s))
    idx[r.uniform(size=(b, s)) < 0.3] = -1
    idx[0] = -1                                    # an empty batch row
    table, counts = ev.transposed_lists(
        torch.as_tensor(idx, dtype=torch.int32), rows)
    table, counts = table.numpy(), counts.numpy()
    assert table.dtype == np.int32 and counts.dtype == np.int32
    want = {}
    for bi in range(b):
        for c in idx[bi]:
            if c >= 0:
                want.setdefault(int(c), []).append(bi)
    assert table.shape == (rows, max(1, max(map(len, want.values()),
                                            default=0)))
    for c in range(rows):
        got = want.get(c, [])
        assert counts[c] == len(got)
        assert list(table[c, :len(got)]) == got     # ascending, complete
        assert (table[c, len(got):] == -1).all()


def test_transposed_lists_of_an_empty_list():
    table, counts = ev.transposed_lists(
        torch.full((4, 3), -1, dtype=torch.int32), 5)
    assert table.shape == (5, 1) and (table == -1).all()
    assert (counts == 0).all()


#: Tree levels of `ranged_case`.
RANGED_LEVELS = 3


def ranged_case(rng, dtype, degree):
    """Ragged leaf ranges (counts 0 and 1, past a chunk), points in their
    leaf's box with some ON its Chebyshev nodes, a node spanning the first
    four leaves and a root spanning all: leaves 0-3 at depth 2, leaves 4-6
    at depth 1 (their particles lack the deepest level; leaf 4 holds two
    chunks and nine tiles). Returns (pts, chunks, chunk_ptr, parent_of,
    lo, hi) for the ranged functions."""
    counts = [0, 1, 5, 300, mcm.CHUNK + 3, 0, 37]
    lo = torch.as_tensor(rng.uniform(-1, 0, (len(counts), 3)), dtype=dtype)
    hi = lo + torch.as_tensor(rng.uniform(0.3, 1, (len(counts), 3)),
                              dtype=dtype)
    grids = cheby.cluster_grid(lo, hi, degree)
    parts = []
    for i, c in enumerate(counts):
        x = lo[i] + (hi[i] - lo[i]) * torch.as_tensor(
            rng.uniform(0, 1, (c, 3)), dtype=dtype)
        k = min(c // 3, grids.shape[1])
        x[:k] = grids[i, :k]                       # exact hits
        parts.append(x)
    pts = torch.cat(parts)
    n, mid = pts.shape[0], sum(counts[:4])
    leaf_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    start = np.append(leaf_start, [0, 0])
    lo = torch.cat([lo, pts[:mid].amin(0, keepdim=True),
                    pts.amin(0, keepdim=True)])
    hi = torch.cat([hi, pts[:mid].amax(0, keepdim=True),
                    pts.amax(0, keepdim=True)])
    chunks, ptr = (torch.as_tensor(a) for a in
                   mcm.chunk_table(start, counts + [mid, n]))
    parent = torch.as_tensor([7, 7, 7, 7, 8, 8, 8, 8, -1])
    return pts, chunks, ptr, parent, lo, hi


@pytest.mark.parametrize("degree", [1, 3, 8])
def test_plain_transpose_is_the_forward_transposed(degree):
    rng = np.random.default_rng(degree)
    dtype = torch.float64
    pts, chunks, ptr, parent, lo, hi = ranged_case(rng, dtype, degree)
    nodes = ops._cluster_nodes(lo, hi, degree)
    w = cheby.bary_weights_1d(degree, dtype)
    q = torch.as_tensor(rng.uniform(-1, 1, pts.shape[0])).requires_grad_()
    qhat_bar = torch.as_tensor(rng.uniform(-1, 1, (lo.shape[0],
                                                   (degree + 1) ** 3)))
    fwd = mcm.modified_charges_ranged_plain(pts, q, chunks, ptr, nodes, w,
                                            degree)
    (want,) = torch.autograd.grad(fwd, q, qhat_bar)
    tiles, chain = mcm.tile_table(chunks, parent, RANGED_LEVELS,
                                  pts.shape[0])
    got = mcm.modified_charges_transpose_ranged_plain(pts, qhat_bar, tiles,
                                                      chain, lo, hi, degree)
    _close(got, want, 1e-12, 1e-14)
    via_ops = ops.modified_charges_transpose_ranged(
        pts, qhat_bar, tiles, chain, lo, hi, degree=degree, backend="torch")
    assert torch.equal(via_ops, got)


@pytest.fixture(scope="module")
def hier_plan():
    r = np.random.default_rng(4)
    x = r.uniform(-1, 1, (1500, 3))
    return TreecodeSolver(TreecodeConfig(theta=0.7, degree=3, leaf_size=32,
                                         precompute="hierarchical",
                                         dtype="float64"),
                          device="cpu").plan(x)


@pytest.mark.parametrize("precompute", ["direct", "hierarchical"])
def test_precompute_transposes_match_autograd(hier_plan, precompute):
    a, degree = hier_plan.arrays, hier_plan.config.degree
    r = np.random.default_rng(5)
    q_sorted = torch.as_tensor(r.uniform(-1, 1, a["src_sorted"].shape[0]))
    q_sorted.requires_grad_()
    qhat = ev._QHAT[precompute](a, q_sorted, degree=degree, backend="torch")
    qhat_bar = torch.as_tensor(r.uniform(-1, 1, tuple(qhat.shape)))
    (want,) = torch.autograd.grad(qhat, q_sorted, qhat_bar)
    got = ev._QHAT_BAR[precompute](a, qhat_bar, degree=degree,
                                   backend="torch")
    _close(got, want, 1e-12, 1e-14)


@pytest.fixture(scope="module")
def device_plan():
    """A device-built f64 plan (degree 3) whose leaves sit at several
    depths: a dense corner, and sparse levels below the dense block."""
    r = np.random.default_rng(9)
    x = r.uniform(-1, 1, (1500, 3))
    x[:400] *= 0.1                                  # a dense corner
    t = torch.as_tensor(x)
    return tbuild.prepare_plan_device(t, t, theta=0.7, degree=3,
                                      leaf_size=32, batch_size=32, depth=6,
                                      batch_depth=5)


def budget_arrays(hierarchical=False):
    """The arrays of a capacity-padded plan with point budgets (260 real
    particles of 300): the padded particles own no chunk."""
    x = np.random.default_rng(6).uniform(-1, 1, (260, 3))
    plan = ev.prepare_plan(x, x, theta=0.7, degree=3, leaf_size=16,
                           batch_size=16, device="cpu")
    if hierarchical:
        plan = ev.add_hierarchical_tables(plan)
    caps = ev.Capacities.for_need(
        dict(ev._plan_dims(plan), num_targets=300, num_sources=300),
        headroom=1.0, base=1)
    return ev.pad_plan(plan, caps).arrays


def _arrays(name, hier_plan, device_plan):
    return {"host": lambda: hier_plan.arrays,
            "device": lambda: device_plan.arrays,
            "budget": budget_arrays}[name]()


def _holders(chunks):
    """{node: (start, end)} of every node owning a chunk (its chunks are
    contiguous and in order)."""
    out = {}
    for nd, b, e in chunks.tolist():
        if b < e:
            s0, e0 = out.get(nd, (b, e))
            out[nd] = (min(s0, b), max(e0, e))
    return out


def _depth(parent, nd):
    d = 0
    while parent[nd] >= 0:
        nd, d = parent[nd], d + 1
    return d


def _covered_once(tiles, n):
    cover = np.zeros(n + 1, np.int64)
    for b, e in tiles.tolist():
        if b < e:
            cover[b] += 1
            cover[e] -= 1
    return bool((np.cumsum(cover)[:n] == 1).all())


@pytest.mark.parametrize("plan", ["host", "device", "budget"])
def test_tile_chains_list_the_holding_nodes_root_first(hier_plan,
                                                       device_plan, plan):
    """The direct transpose's table: every tile's chain is exactly the
    nodes whose range holds the tile, root first (chain position = tree
    depth), -1 past its leaf; tiles of at most TILE particles; the tiles
    cover every particle once (the point-budget padding: one last tile
    with an empty chain)."""
    a = _arrays(plan, hier_plan, device_plan)
    n, levels = a["src_sorted"].shape[0], len(a["bucket_nodes"])
    tiles, chain = mcm.tile_table(a["mc_chunks"], a["parent_of"], levels, n)
    assert tiles.dtype == chain.dtype == torch.int32
    assert chain.shape == (tiles.shape[0], levels)
    holders = _holders(a["mc_chunks"])
    parent = a["parent_of"].tolist()
    depths, empty = set(), []
    for (b, e), row in zip(tiles.tolist(), chain.tolist()):
        k = sum(v >= 0 for v in row)
        assert all(v >= 0 for v in row[:k]) and all(v == -1 for v in row[k:])
        if b >= e:
            continue
        if k == 0:
            empty.append((b, e))
            continue
        assert e - b <= mcm.TILE
        assert sorted(row[:k]) == sorted(
            nd for nd, (s0, e0) in holders.items() if s0 <= b and e <= e0)
        assert [_depth(parent, v) for v in row[:k]] == list(range(k))
        depths.add(k)
    assert _covered_once(tiles, n)
    real = max(e for (_, e) in holders.values())
    assert empty == ([(real, n)] if real < n else [])
    if plan == "budget":
        assert real == 260 and n == 300
    else:
        assert len(depths) > 1, depths           # leaves at several depths


@pytest.mark.parametrize("plan", ["host", "budget"])
def test_leaf_tiles_have_chains_of_one_node(hier_plan, plan):
    """The hierarchical transpose's table over the leaves' chunks: every
    chain is its leaf alone, and the tiles cover every particle once."""
    a = hier_plan.arrays if plan == "host" else budget_arrays(True)
    n = a["src_sorted"].shape[0]
    tiles, chain = mcm.tile_table(a["mc_leaf_chunks"], a["parent_of"], 1, n)
    assert chain.shape == (tiles.shape[0], 1)
    leaves = _holders(a["mc_leaf_chunks"])
    for (b, e), (nd,) in zip(tiles.tolist(), chain.tolist()):
        if b < e and nd >= 0:
            s0, e0 = leaves[nd]
            assert s0 <= b and e <= e0
    assert _covered_once(tiles, n)


def test_direct_transpose_of_a_device_plan_matches_autograd(device_plan):
    a, degree = device_plan.arrays, 3
    r = np.random.default_rng(10)
    q_sorted = torch.as_tensor(r.uniform(-1, 1, a["src_sorted"].shape[0]))
    q_sorted.requires_grad_()
    qhat = ev.compute_qhat_direct(a, q_sorted, degree=degree,
                                  backend="torch")
    qhat_bar = torch.as_tensor(r.uniform(-1, 1, tuple(qhat.shape)))
    (want,) = torch.autograd.grad(qhat, q_sorted, qhat_bar)
    got = ev._qhat_bar_direct(a, qhat_bar, degree=degree, backend="torch")
    _close(got, want, 1e-12, 1e-14)


SWAP_CASES = [(FREE, coulomb(), "diff"), (FREE, yukawa(0.7), "matmul"),
              (PeriodicBox((1.5, 2.0, 1.7)), coulomb(), "diff"),
              (PeriodicBox((1.5, 2.0, 1.7)), yukawa(1.3), "diff")]


@pytest.mark.parametrize("case", range(len(SWAP_CASES)))
@pytest.mark.parametrize("kahan", [False, True])
def test_swapped_roles_are_the_transpose(case, kahan):
    space, kern, r2 = SWAP_CASES[case]
    rng = np.random.default_rng(case)
    b, nb, c, m, s = 6, 40, 9, 50, 5
    tgt = torch.as_tensor(rng.uniform(-1, 1, (b, nb, 3)))
    src = torch.as_tensor(rng.uniform(-1, 1, (c, m, 3)))
    q = torch.as_tensor(rng.uniform(-1, 1, (c, m)))
    u = torch.as_tensor(rng.uniform(-1, 1, (b, nb)))
    idx = torch.as_tensor(rng.integers(-1, c, (b, s)), dtype=torch.int32)
    tc = torch.as_tensor(rng.integers(0, nb + 1, b), dtype=torch.int32)
    sc = torch.as_tensor(rng.integers(0, m + 1, c), dtype=torch.int32)
    kw = dict(kernel=kern, space=space, kahan=kahan, r2_mode=r2)
    phi = bcm.batch_cluster_eval_plain(idx, tgt, src, q, tgt_count=tc,
                                       src_count=sc, **kw)
    rows, _ = ev.transposed_lists(idx, c)
    # padded slots of u beyond the counts must not matter
    back = bcm.batch_cluster_eval_plain(rows, src, tgt, u, tgt_count=sc,
                                        src_count=tc, **kw)
    lhs, rhs = float((u * phi).sum()), float((back * q).sum())
    scale = float((u.abs() * bcm.batch_cluster_eval_plain(
        idx, tgt, src, q.abs(), tgt_count=tc, src_count=sc,
        **dict(kw, kahan=False)).abs()).sum())
    assert abs(lhs - rhs) <= 1e-13 * scale
    assert (back[torch.arange(m)[None, :] >= sc[:, None]] == 0).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [1, 4, 8, 14])
def test_transpose_kernel_matches_plain(cuda_device, dtype, degree):
    """The three-level case (leaves at two depths, tile and chunk
    boundaries inside one leaf), and a point-budgeted plan's table (a
    tail of padded particles with an empty chain: exactly 0; six leaves
    of one particle, boxes flat in every dimension, whose rows hit all
    n+1 nodes: the denominator is the count of hits, as in the plain
    version)."""
    rng = np.random.default_rng(degree)
    pts, chunks, _, parent, lo, hi = ranged_case(rng, dtype, degree)
    cases = [(pts, chunks, parent, RANGED_LEVELS, lo, hi)]
    a = budget_arrays()
    cases.append((a["src_sorted"].to(dtype), a["mc_chunks"], a["parent_of"],
                  len(a["bucket_nodes"]), a["node_lo"].to(dtype),
                  a["node_hi"].to(dtype)))
    rtol, floor = (3e-3, 3e-4) if dtype == torch.float32 else (1e-10, 1e-12)
    for pts, chunks, parent, levels, lo, hi in cases:
        pts, chunks, parent, lo, hi = (
            t.to(cuda_device) for t in (pts, chunks, parent, lo, hi))
        tiles, chain = mcm.tile_table(chunks, parent, levels, pts.shape[0])
        qhat_bar = torch.as_tensor(rng.uniform(-1, 1, (lo.shape[0],
                                                       (degree + 1) ** 3)),
                                   dtype=dtype, device=cuda_device)
        args = (pts, qhat_bar, tiles, chain, lo, hi)
        before = mcm.TRANSPOSE_LAUNCHES
        got = ops.modified_charges_transpose_ranged(*args, degree=degree)
        assert mcm.TRANSPOSE_LAUNCHES == before + 1
        again = ops.modified_charges_transpose_ranged(*args, degree=degree)
        assert torch.equal(got, again)
        want = ops.modified_charges_transpose_ranged(*args, degree=degree,
                                                     backend="torch")
        _close(got, want, rtol, floor)
        uncovered = tiles[(chain < 0).all(1)]
        for b, e in uncovered.tolist():
            assert (got[b:e] == 0).all()


def _raise(*args, **kw):
    raise AssertionError("a plain version ran on CUDA tensors")


@pytest.mark.cuda
@pytest.mark.parametrize("precompute", ["direct", "hierarchical"])
def test_cuda_backward_has_no_fallback(cuda_device, monkeypatch, precompute):
    r = np.random.default_rng(12)
    x = r.uniform(-1, 1, (3000, 3))
    q, u = r.uniform(-1, 1, 3000), r.uniform(-1, 1, 3000)
    cfg = TreecodeConfig(theta=0.7, degree=4, leaf_size=64, skin=0.02,
                         precompute=precompute, dtype="float64")
    out = {}
    for dev in ("cpu", cuda_device):
        plan = TreecodeSolver(cfg, device=dev).plan(x)
        a = dict(plan.arrays)
        tgt = a["tgt_batched"].clone().requires_grad_()
        a["tgt_batched"] = tgt
        qt = torch.as_tensor(q, device=dev).requires_grad_()
        phi = ev.differentiable_execute(a, qt, plan.kernel_params,
                                        **plan.config.exec_opts(plan.kernel))
        if dev != "cpu":
            for name in ("batch_cluster_eval_plain",
                         "batch_cluster_field_plain",
                         "batch_cluster_field_grid_plain"):
                monkeypatch.setattr(bcm, name, _raise)
            for name in ("modified_charges_ranged_plain",
                         "modified_charges_transpose_ranged_plain"):
                monkeypatch.setattr(mcm, name, _raise)
        launches = (bcm.LAUNCHES, mcm.TRANSPOSE_LAUNCHES,
                    bcm.FIELD_LAUNCHES, bcm.GRID_FIELD_LAUNCHES)
        grads = torch.autograd.grad(phi, (tgt, qt),
                                    torch.as_tensor(u, device=dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (bcm.LAUNCHES - launches[0],
                    mcm.TRANSPOSE_LAUNCHES - launches[1],
                    bcm.FIELD_LAUNCHES - launches[2],
                    bcm.GRID_FIELD_LAUNCHES - launches[3]) == (2, 1, 1, 1)
        out[str(dev)] = [g.cpu() for g in grads] + [phi.detach().cpu()]
    mask = plan.arrays["tgt_mask"].cpu()
    (tc, qc, pc), (tg, qg, pg) = out["cpu"], out[str(cuda_device)]
    _close(pg, pc, 1e-10, 1e-12)
    _close(qg, qc, 1e-10, 1e-12)
    _close(tg[mask], tc[mask], 1e-10, 1e-12)

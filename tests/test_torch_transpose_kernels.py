"""The transposed pass's pieces: lists, kernels' transposes, no fallback.

- `eval.transposed_lists`: every valid (batch, cluster) pair of a -1-padded
  list appears exactly once in its cluster's row, batches ascending,
  -1 after them, with the counts.
- `modified_charges_transpose_ranged_plain` against `torch.autograd.grad`
  of `modified_charges_ranged_plain` (exact hits on the nodes, nodes with
  no particle, a node spanning the others), f64 rtol 1e-12 with a floor of
  1e-14 max|want| (the same sums in another order).
- The hierarchical precompute's transpose against autograd of
  `compute_qhat_hierarchical`, and the direct one's, on a plan (f64, the
  same bar).
- The batch-cluster kernel's plain version with the roles swapped is the
  transpose of the forward: <u, B(q)> = <B^T(u), q> to 1e-13 relative in
  f64, free and periodic, Coulomb and Yukawa, the matmul r^2, with counts.
- On the card (marked `cuda`, skipped without one): the transposed
  modified-charge kernel against its plain version (f32 rtol 3e-3 / atol
  3e-4 max|want|, f64 1e-10 / 1e-12 max|want|, the forward's bars in
  `chip_smoke.py`), bitwise equal on a second call; the CUDA backward of
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


def ranged_case(rng, dtype, degree):
    """Ragged node ranges (counts 0 and 1, past a chunk), points in their
    node's box with some ON its Chebyshev nodes, and a last node spanning
    all the others (a parent level): (pts, chunks, chunk_ptr, levels,
    nodes, w) for the ranged functions."""
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
    n = pts.shape[0]
    start = np.append(np.concatenate([[0], np.cumsum(counts)[:-1]]), 0)
    lo = torch.cat([lo, pts.amin(0, keepdim=True)])
    hi = torch.cat([hi, pts.amax(0, keepdim=True)])
    chunks, ptr = (torch.as_tensor(a) for a in
                   mcm.chunk_table(start, counts + [n]))
    levels = (chunks[:, 0] != len(counts)).to(torch.int32)  # the span: 0
    return pts, chunks, ptr, levels, lo, hi


@pytest.mark.parametrize("degree", [1, 3, 8])
def test_plain_transpose_is_the_forward_transposed(degree):
    rng = np.random.default_rng(degree)
    dtype = torch.float64
    pts, chunks, ptr, _, lo, hi = ranged_case(rng, dtype, degree)
    nodes = ops._cluster_nodes(lo, hi, degree)
    w = cheby.bary_weights_1d(degree, dtype)
    q = torch.as_tensor(rng.uniform(-1, 1, pts.shape[0])).requires_grad_()
    qhat_bar = torch.as_tensor(rng.uniform(-1, 1, (lo.shape[0],
                                                   (degree + 1) ** 3)))
    fwd = mcm.modified_charges_ranged_plain(pts, q, chunks, ptr, nodes, w,
                                            degree)
    (want,) = torch.autograd.grad(fwd, q, qhat_bar)
    got = mcm.modified_charges_transpose_ranged_plain(pts, qhat_bar, chunks,
                                                      nodes, w, degree)
    _close(got, want, 1e-12, 1e-14)
    via_ops = ops.modified_charges_transpose_ranged(
        pts, qhat_bar, chunks, torch.zeros_like(chunks[:, 0]), lo, hi,
        num_levels=1, degree=degree, backend="torch")
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


def test_chunk_levels_are_disjoint(hier_plan):
    """Chunks of one level cover every particle at most once (what the
    kernel's level partials need)."""
    a = hier_plan.arrays
    level, num_levels = ev._chunk_levels(a, a["mc_chunks"])
    assert num_levels == len(a["bucket_nodes"])
    n = a["src_sorted"].shape[0]
    for lvl in range(num_levels):
        cover = torch.zeros(n + 1, dtype=torch.int64)
        rows = a["mc_chunks"][level == lvl].long()
        cover.index_add_(0, rows[:, 1], torch.ones(len(rows),
                                                   dtype=torch.int64))
        cover.index_add_(0, rows[:, 2], -torch.ones(len(rows),
                                                    dtype=torch.int64))
        assert int(cover.cumsum(0).max()) <= 1, lvl


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
    rng = np.random.default_rng(degree)
    pts, chunks, _, levels, lo, hi = (
        t.to(cuda_device) for t in ranged_case(rng, dtype, degree))
    qhat_bar = torch.as_tensor(rng.uniform(-1, 1, (lo.shape[0],
                                                   (degree + 1) ** 3)),
                               dtype=dtype, device=cuda_device)
    args = (pts, qhat_bar, chunks, levels, lo, hi)
    before = mcm.TRANSPOSE_LAUNCHES
    got = ops.modified_charges_transpose_ranged(*args, num_levels=2,
                                                degree=degree)
    assert mcm.TRANSPOSE_LAUNCHES == before + 2
    again = ops.modified_charges_transpose_ranged(*args, num_levels=2,
                                                  degree=degree)
    assert torch.equal(got, again)
    want = ops.modified_charges_transpose_ranged(*args, num_levels=2,
                                                 degree=degree,
                                                 backend="torch")
    rtol, floor = (3e-3, 3e-4) if dtype == torch.float32 else (1e-10, 1e-12)
    _close(got, want, rtol, floor)


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
                    bcm.GRID_FIELD_LAUNCHES - launches[3]) == (2, 2, 1, 1)
        out[str(dev)] = [g.cpu() for g in grads] + [phi.detach().cpu()]
    mask = plan.arrays["tgt_mask"].cpu()
    (tc, qc, pc), (tg, qg, pg) = out["cpu"], out[str(cuda_device)]
    _close(pg, pc, 1e-10, 1e-12)
    _close(qg, qc, 1e-10, 1e-12)
    _close(tg[mask], tc[mask], 1e-10, 1e-12)

"""The ranged modified charges: the chunk table and the plain version.

`modified_charges.chunk_table` cuts each node's particle range into
chunks of at most P particles; `ops.modified_charges_ranged` computes
q_hat of every node from those chunks. Its plain version is held against
`repro.core.eval.compute_qhat_direct(backend="xla")` on the reference's
own plan arrays: f64 at rtol 1e-10, f32 at rtol 3e-3 / atol 3e-4."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import eval as jeval
from repro.core import space as jspace
from repro_torch.core import eval as teval
from repro_torch.core import space as tspace
from repro_torch.kernels import modified_charges as tmc
from repro_torch.kernels import ops as tops

P = tmc.CHUNK
L = 2.0
SPACES = {"free": (jspace.FREE, tspace.FREE),
          "periodic": (jspace.PeriodicBox((L, L, L)),
                       tspace.PeriodicBox((L, L, L)))}


def _assert_table(chunks, ptr, start, count, chunk):
    """Every node's range covered once, in order, by chunks <= `chunk`."""
    assert chunks.dtype == ptr.dtype == np.int32
    assert chunks.ndim == 2 and chunks.shape[1] == 3
    assert ptr.shape == (len(count) + 1,) and ptr[0] == 0
    assert ptr[-1] == len(chunks) and (np.diff(ptr) >= 0).all()
    for i, (s, c) in enumerate(zip(start, count)):
        rows = chunks[ptr[i]:ptr[i + 1]]
        assert len(rows) == -(-c // chunk)
        assert (rows[:, 0] == i).all()
        if c == 0:
            continue
        assert rows[0, 1] == s and rows[-1, 2] == s + c
        assert (rows[1:, 1] == rows[:-1, 2]).all()   # contiguous, in order
        size = rows[:, 2] - rows[:, 1]
        assert (size >= 1).all() and (size <= chunk).all()


@pytest.mark.parametrize("chunk", [P, 7])
def test_chunk_table_random_ranges(chunk):
    r = np.random.default_rng(chunk)
    edge = [0, chunk - 1, chunk, chunk + 1, 3 * chunk + 5, 1, 0]
    count = np.concatenate([edge, r.integers(0, 4 * chunk, 40)])
    r.shuffle(count)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    start = start + r.integers(0, 3, len(count)).cumsum()   # gaps
    chunks, ptr = tmc.chunk_table(start, count, chunk)
    _assert_table(chunks, ptr, start, count, chunk)
    assert int((chunks[:, 2] - chunks[:, 1]).sum()) == int(count.sum())


def test_chunk_table_empty_and_overlapping_levels():
    chunks, ptr = tmc.chunk_table(np.zeros(3), np.zeros(3))
    assert chunks.shape == (0, 3) and list(ptr) == [0, 0, 0, 0]
    # a tree's levels overlap: the root and its children share particles
    start = np.array([0, 0, P + 3])
    count = np.array([2 * P + 6, P + 3, P + 3])
    chunks, ptr = tmc.chunk_table(start, count)
    _assert_table(chunks, ptr, start, count, P)
    assert chunks[:, 0].tolist() == [0, 0, 0, 1, 1, 2, 2]


@pytest.mark.parametrize("space", ["free", "periodic"])
def test_plan_chunk_table_covers_every_node(space):
    """`prepare_plan` holds the chunk table of its tree: each node's range
    [start, start+count) of the tree-ordered sources, once per plan."""
    r = np.random.default_rng(3)
    x = r.uniform(0, L, (3000, 3))
    plan = teval.prepare_plan(x, x, theta=0.7, degree=2, leaf_size=64,
                              batch_size=64, space=SPACES[space][1],
                              device="cpu")
    a, tree = plan.arrays, plan.tree
    chunks, ptr = a["mc_chunks"].numpy(), a["mc_chunk_ptr"].numpy()
    assert a["mc_chunks"].dtype == a["mc_chunk_ptr"].dtype == torch.int32
    _assert_table(chunks, ptr, tree.start, tree.count, P)
    assert ptr[1] - ptr[0] == 2                    # the root is split
    # exactly the particle-levels the tree holds: no padding
    assert int((chunks[:, 2] - chunks[:, 1]).sum()) == int(tree.count.sum())


def _reference_plan(x, space, degree):
    js, _ = SPACES[space]
    jp = jeval.prepare_plan(x, x, theta=0.7, degree=degree, leaf_size=64,
                            batch_size=64, space=js)
    arrays = {k: (tuple(map(np.asarray, v)) if isinstance(v, tuple)
                  else np.asarray(v)) for k, v in jp.arrays.items()}
    return jp, arrays


def _ranged_vs_reference(space, degree, dtype, rtol, atol_of):
    r = np.random.default_rng(degree)
    x = r.uniform(0, L, (2500, 3)).astype(dtype)
    q = r.uniform(-1, 1, 2500).astype(dtype)
    jp, np_arrays = _reference_plan(x, space, degree)
    perm = np_arrays["src_perm"]
    want = np.asarray(jeval.compute_qhat_direct(
        jp.arrays, jnp.asarray(q[perm]), degree=degree, backend="xla"))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    a = teval.arrays_from_numpy(np_arrays, device="cpu", dtype=tdt)
    q_sorted = torch.as_tensor(q[perm])
    got = teval.compute_qhat_direct(a, q_sorted, degree=degree,
                                    backend="torch")
    assert got.dtype == tdt and got.shape == want.shape
    atol = atol_of(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    # the same q_hat from a finer cut: chunks of 37 particles
    chunks, ptr = (torch.as_tensor(t) for t in tmc.chunk_table(
        *teval.node_ranges(np_arrays), 37))
    fine = tops.modified_charges_ranged(
        a["src_sorted"], q_sorted, chunks, ptr, a["node_lo"], a["node_hi"],
        degree=degree, backend="torch")
    np.testing.assert_allclose(fine.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("space", ["free", "periodic"])
@pytest.mark.parametrize("degree", [1, 4, 8])
def test_ranged_plain_matches_reference_f64(x64, space, degree):
    """f64 at rtol 1e-10. q_hat sums signed Lagrange products, so an entry
    can cancel towards 0; the atol floor is 1e-12 max|q_hat|, the
    rounding of the largest terms in another summation order."""
    _ranged_vs_reference(space, degree, np.float64, 1e-10,
                         lambda w: 1e-12 * np.abs(w).max())


@pytest.mark.parametrize("space", ["free", "periodic"])
@pytest.mark.parametrize("degree", [1, 4, 8])
def test_ranged_plain_matches_reference_f32(space, degree):
    _ranged_vs_reference(space, degree, np.float32, 3e-3, lambda w: 3e-4)


def test_ranged_plain_empty_node_and_dense_form():
    """A node with count 0 gets a row of 0; the ranged form over C
    clusters of m points equals the dense (C, m) form."""
    r = np.random.default_rng(9)
    c, m, degree = 3, 50, 5
    pts = torch.as_tensor(r.uniform(0, 1, (c, m, 3)))
    q = torch.as_tensor(r.uniform(-1, 1, (c, m)))
    lo, hi = pts.amin(1), pts.amax(1)
    dense = tops.modified_charges(pts, q, lo, hi, degree=degree)
    start = np.array([0, m, 0, 2 * m])
    count = np.array([m, m, 0, m])
    chunks, ptr = (torch.as_tensor(t) for t in
                   tmc.chunk_table(start, count, 16))
    lo4 = torch.cat([lo[:2], lo[:1], lo[2:]])
    hi4 = torch.cat([hi[:2], hi[:1], hi[2:]])
    got = tops.modified_charges_ranged(
        pts.reshape(-1, 3), q.reshape(-1), chunks, ptr, lo4, hi4,
        degree=degree)
    assert (got[2] == 0).all()
    np.testing.assert_allclose(got[[0, 1, 3]].numpy(), dense.numpy(),
                               rtol=1e-10, atol=1e-12)

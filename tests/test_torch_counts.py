"""The batch-cluster count contract of repro_torch against the JAX reference.

Targets are packed from slot 0 of each batch row and leaf particles from
slot 0 of each leaf, so `tgt_count` (B,) and `src_count` (C,) are prefix
lengths. With counts, `batch_cluster_eval` sums only the first
``src_count[c]`` points of cluster c and gives phi = 0 on target slots at
or beyond ``tgt_count[b]``. The reference has no counts: it sees the same
inputs with zero charges on the skipped points, which by the contract
gives the same sums on every real target slot. Inputs come from a numpy
seed; the points the port skips carry nonzero charges and the padded
target slots real coordinates, so only the counts can make them vanish."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import potentials as jpot
from repro.core import space as jspace
from repro.kernels import ops as jops
from repro_torch.core import eval as teval
from repro_torch.core import potentials as tpot
from repro_torch.core import space as tspace
from repro_torch.kernels import batch_cluster as tbc
from repro_torch.kernels import ops as tops

L = (1.3, 1.1, 1.7)
SPACES = {"free": (jspace.FREE, tspace.FREE),
          "periodic": (jspace.PeriodicBox(L), tspace.PeriodicBox(L))}
KERNELS = {"coulomb": {}, "yukawa": {"kappa": 0.5}}


def _counted_case(seed, B, S, NB, C, m, dtype):
    """Inputs with ragged counts: row 0 empty, row 1 full, the last
    cluster empty, cluster 0 full, the rest off the unroll and the tile;
    interior -1 sentinels and a slot on the empty cluster."""
    r = np.random.default_rng(seed)
    tgt = r.uniform(-1, 1, (B, NB, 3)).astype(dtype)
    src = r.uniform(-1, 1, (C, m, 3)).astype(dtype)
    q = r.uniform(0.1, 1, (C, m)).astype(dtype)   # no cancellation
    idx = r.integers(-1, C, (B, S)).astype(np.int32)
    idx[:, S // 2] = -1
    idx[-1, 0] = C - 1
    tc = r.integers(1, NB + 1, B).astype(np.int32)
    tc[tc % tbc._SOURCE_UNROLL == 0] -= 1
    tc[0], tc[1] = 0, NB
    sc = r.integers(1, m + 1, C).astype(np.int32)
    sc[0], sc[-1] = m, 0
    return idx, tgt, src, q, tc, sc


def _reference(idx, tgt, src, q, sc, kernel, space, kahan, r2_mode,
               backend="xla"):
    """The reference on the same inputs, skipped points at zero charge."""
    keep = np.arange(src.shape[1])[None, :] < sc[:, None]
    qz = np.where(keep, q, 0).astype(q.dtype)
    jk = jpot.get_kernel(kernel, **KERNELS[kernel])
    return np.asarray(jops.batch_cluster_eval(
        jnp.asarray(idx), jnp.asarray(tgt), jnp.asarray(src),
        jnp.asarray(qz), kernel=jk, space=space, backend=backend,
        kahan=kahan, r2_mode=r2_mode, target_tile=16))


def _port(idx, tgt, src, q, tc, sc, kernel, space, kahan, r2_mode):
    tk = tpot.get_kernel(kernel, **KERNELS[kernel])
    return tops.batch_cluster_eval(
        *map(torch.as_tensor, (idx, tgt, src, q)), kernel=tk, space=space,
        kahan=kahan, r2_mode=r2_mode, tgt_count=torch.as_tensor(tc),
        src_count=torch.as_tensor(sc)).numpy()


def _check(got, want, tc, rtol):
    real = np.arange(got.shape[1])[None, :] < tc[:, None]
    assert (got[~real] == 0).all()                 # exactly 0, not small
    np.testing.assert_allclose(got[real], want[real], rtol=rtol)


@pytest.mark.parametrize("space", ["free", "periodic"])
@pytest.mark.parametrize("kernel", ["coulomb", "yukawa"])
@pytest.mark.parametrize("kahan", [False, True])
def test_counts_f64_match_reference(x64, space, kernel, kahan):
    """f64 at rtol 1e-12, NB and m off the tile and the unroll."""
    js, ts = SPACES[space]
    idx, tgt, src, q, tc, sc = _counted_case(7, 4, 5, 140, 6, 37,
                                             np.float64)
    got = _port(idx, tgt, src, q, tc, sc, kernel, ts, kahan, "diff")
    assert got.dtype == np.float64
    want = _reference(idx, tgt, src, q, sc, kernel, js, kahan, "diff")
    _check(got, want, tc, 1e-12)


@pytest.mark.parametrize("space", ["free", "periodic"])
@pytest.mark.parametrize("kahan", [False, True])
def test_counts_f32_match_reference(space, kahan):
    js, ts = SPACES[space]
    idx, tgt, src, q, tc, sc = _counted_case(8, 5, 6, 131, 7, 29,
                                             np.float32)
    got = _port(idx, tgt, src, q, tc, sc, "coulomb", ts, kahan, "diff")
    assert got.dtype == np.float32
    want = _reference(idx, tgt, src, q, sc, "coulomb", js, kahan, "diff")
    _check(got, want, tc, 1e-5)


def test_counts_matmul_r2_match_pallas_body():
    """The matmul-r2 form (MAC-separated sources) against the Pallas body
    in interpret mode."""
    idx, tgt, src, q, tc, sc = _counted_case(9, 3, 4, 24, 5, 19,
                                             np.float32)
    src = src + np.float32(4.0)
    got = _port(idx, tgt, src, q, tc, sc, "coulomb", tspace.FREE, False,
                "matmul")
    want = _reference(idx, tgt, src, q, sc, "coulomb", jspace.FREE, False,
                      "matmul", backend="pallas_interpret")
    _check(got, want, tc, 1e-5)


def test_full_counts_equal_no_counts():
    """Counts that cover every slot change nothing, bit for bit."""
    idx, tgt, src, q, _, _ = _counted_case(10, 3, 4, 20, 4, 12,
                                           np.float32)
    tk = tpot.coulomb()
    args = [torch.as_tensor(a) for a in (idx, tgt, src, q)]
    plain = tops.batch_cluster_eval(*args, kernel=tk, kahan=True)
    full = tops.batch_cluster_eval(
        *args, kernel=tk, kahan=True,
        tgt_count=torch.full((3,), 20, dtype=torch.int32),
        src_count=torch.full((4,), 12, dtype=torch.int32))
    assert torch.equal(plain, full)


def test_swept_pairs_geometry():
    """What the CUDA launch sweeps: whole 128-target tiles with a real
    target, each cluster's points rounded up to the unroll of 4."""
    idx = torch.tensor([[0, -1, 1], [1, 1, -1], [2, -1, -1]],
                       dtype=torch.int32)
    tc = torch.tensor([129, 0, 5], dtype=torch.int32)
    sc = torch.tensor([5, 8, 0], dtype=torch.int32)
    geo = tbc.swept_pairs(idx, 300, 9, tgt_count=tc, src_count=sc)
    # row 0: 2 tiles x (8 + 8) points; row 1: no tile; row 2: 1 tile x 0
    assert geo == {"pairs": 2 * 128 * 16.0, "tiles": 3,
                   "tiles_launched": 9}
    full = tbc.swept_pairs(idx, 300, 9)
    assert full["pairs"] == 3 * 128 * (2 + 2 + 1) * 12.0
    assert full["tiles"] == full["tiles_launched"] == 9


def test_kernel_inputs_counts_and_direct_lane():
    """`kernel_inputs` derives int32 prefix counts from the plan, and the
    direct lane with counts equals the lane without them on every real
    target slot (padded leaf particles carry zero charge)."""
    r = np.random.default_rng(11)
    x = r.uniform(0, 1, (900, 3))
    q = torch.as_tensor(r.uniform(-1, 1, 900))
    plan = teval.prepare_plan(x, x, theta=0.7, degree=2, leaf_size=40,
                              batch_size=40, device="cpu")
    a = plan.arrays
    inp = teval.kernel_inputs(a, q, degree=2)
    assert inp.tgt_count.dtype == inp.leaf_count.dtype == torch.int32
    assert torch.equal(inp.tgt_count.long(), a["tgt_mask"].sum(1))
    assert torch.equal(inp.leaf_count.long(),
                       (a["leaf_gather"] >= 0).sum(1))
    assert int(inp.tgt_count.min()) < a["tgt_batched"].shape[1]  # ragged
    tk = tpot.coulomb()
    kw = dict(kernel=tk, backend="torch")
    full = tops.batch_cluster_eval(a["direct_idx"], a["tgt_batched"],
                                   inp.leaf_pts, inp.leaf_q, **kw)
    counted = tops.batch_cluster_eval(
        a["direct_idx"], a["tgt_batched"], inp.leaf_pts, inp.leaf_q,
        tgt_count=inp.tgt_count, src_count=inp.leaf_count, **kw)
    mask = a["tgt_mask"]
    assert (counted[~mask] == 0).all()
    np.testing.assert_allclose(counted[mask].numpy(), full[mask].numpy(),
                               rtol=1e-12)


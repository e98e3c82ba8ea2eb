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

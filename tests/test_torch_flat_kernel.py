"""The modified charges on nodes flat in a dimension: the plain version
on the CPU and, on the card (marked `cuda`), the kernel against it.

Boxes are shrunk to their particles, so a node whose particles share a
coordinate has lo == hi there, and all n+1 Chebyshev nodes of that
dimension coincide: every particle hits all of them. The plain version
(`cheby.bary_terms`) takes the 0/1 row of the hits over their count, so
each coincident node carries 1/(n+1) of the charge and a node's q_hat
sums to its charge; `modified_charges_ranged_cuda` takes the same count.
Nodes flat in one, two and three dimensions (a sheet, a line, a point),
with counts 1, 37, 300 and past a chunk and their parent; f32 and f64.

No JAX here, so the card's tests collect where it is not installed
(`tests/test_torch_flat_nodes.py` holds these cases against `repro`).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cheby
from repro_torch.kernels import modified_charges as mcm
from repro_torch.kernels import ops

#: A node's flat dimensions in the cases: a sheet, a line, a point.
FLAT = {"1d": (2,), "2d": (1, 2), "3d": (0, 1, 2)}
DEGREES = [1, 4, 8, 14]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_case(rng, dtype, degree, flat, device="cpu"):
    """Nodes whose particles share their coordinates in the dimensions
    `flat` (all nodes on one plane, line or point there, so the last node,
    spanning the others as a parent does, is flat too): counts 1, 37, 300
    and past a chunk, some particles ON a Chebyshev node in the other
    dimensions (exact hits there as well). Returns (pts, q, chunks,
    chunk_ptr, lo, hi, counts) for the ranged functions."""
    counts = [1, 37, 300, mcm.CHUNK + 3]
    plane = torch.as_tensor(rng.uniform(-1, 1, 3), dtype=dtype)
    parts = []
    for c in counts:
        lo = torch.as_tensor(rng.uniform(-1, 0, 3), dtype=dtype)
        x = lo + torch.as_tensor(rng.uniform(0, 1, (c, 3)), dtype=dtype)
        for d in flat:
            x[:, d] = plane[d]
        box_lo, box_hi = x.amin(0, keepdim=True), x.amax(0, keepdim=True)
        grid = cheby.cluster_grid(box_lo, box_hi, degree)[0]
        k = min(c // 3, grid.shape[0])
        x[:k] = grid[:k]                           # exact hits
        parts.append(x)
    pts = torch.cat(parts)
    n = pts.shape[0]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    bounds = [(int(s), int(s) + c) for s, c in zip(start, counts)] + [(0, n)]
    lo = torch.stack([pts[b:e].amin(0) for b, e in bounds])
    hi = torch.stack([pts[b:e].amax(0) for b, e in bounds])
    for d in flat:
        assert (lo[:, d] == hi[:, d]).all()
    chunks, ptr = mcm.chunk_table(np.append(start, 0), counts + [n])
    q = torch.as_tensor(rng.uniform(-1, 1, n), dtype=dtype)
    to = dict(device=device)
    return (pts.to(**to), q.to(**to), torch.as_tensor(chunks, **to),
            torch.as_tensor(ptr, **to), lo.to(**to), hi.to(**to),
            counts + [n])


def node_charges(q, counts):
    """The charge of each node of `flat_case` (the last spans all)."""
    ends = np.cumsum(counts[:-1])
    sums = [q[e - c:e].sum() for c, e in zip(counts[:-1], ends)]
    return torch.stack(sums + [q.sum()])


@pytest.mark.parametrize("flat", list(FLAT))
@pytest.mark.parametrize("degree", DEGREES)
def test_plain_q_hat_sums_to_the_node_charge(flat, degree):
    case = flat_case(np.random.default_rng(degree), torch.float64, degree,
                     FLAT[flat])
    pts, q, chunks, ptr, lo, hi, counts = case
    got = ops.modified_charges_ranged(pts, q, chunks, ptr, lo, hi,
                                      degree=degree, backend="torch")
    torch.testing.assert_close(got.sum(1), node_charges(q, counts),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("flat", list(FLAT))
def test_kernel_on_flat_nodes_matches_plain(cuda_device, dtype, degree,
                                            flat):
    """The ranged kernel against its plain version on flat nodes; each
    node's q_hat sums to its charge (the kernel takes the count of hits
    as the denominator, as the plain version does)."""
    case = flat_case(np.random.default_rng(degree), dtype, degree,
                     FLAT[flat], cuda_device)
    pts, q, chunks, ptr, lo, hi, counts = case
    args = (pts, q, chunks, ptr, lo, hi)
    got = ops.modified_charges_ranged(*args, degree=degree, backend="cuda")
    want = ops.modified_charges_ranged(*args, degree=degree, backend="torch")
    rtol, floor = (3e-3, 3e-4) if dtype == torch.float32 else (1e-10, 1e-12)
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=floor * want.abs().max().item())
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    charges = node_charges(q, counts)
    torch.testing.assert_close(got.sum(1), charges, rtol=tol,
                               atol=tol * q.abs().sum().item())

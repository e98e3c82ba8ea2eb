"""Nodes flat in a dimension (a sheet, a line, one point), held against
`repro` on the CPU.

Boxes are shrunk to their particles, so a node whose particles share a
coordinate has lo == hi there, and all n+1 Chebyshev nodes of that
dimension coincide: every particle hits all of them. `cheby.bary_terms`
(and the reference's) takes the 0/1 row of the hits over their count, so
each coincident node carries 1/(n+1) of the charge and a node's q_hat
still sums to its charge. The CUDA kernel takes the same count.

- The plain modified charges on nodes flat in one, two and three
  dimensions: each node's q_hat sums to its charge, and equals the
  reference's XLA and Pallas (interpret mode) modified charges (f64).
- A sheet of 10,000 points on z = 0 at the Fig. 4 setting (theta 0.7,
  degree 8) with leaves of 200, so nodes of more than (n+1)^3 = 729
  particles, all flat in z, are swept in the approximation lane:
  `execute` and `potential_and_forces` equal the reference's at f64 rtol
  1e-10 (atol 1e-12 max|want|), through the host and the device build,
  and with the hierarchical precompute.

The cases, and the kernel's test on the card, are in
`tests/test_torch_flat_kernel.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.kernels import ops as jops
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.kernels import ops
from test_torch_flat_kernel import FLAT, flat_case, node_charges

FIG4 = dict(theta=0.7, degree=8)
SHEET_N, SHEET_LEAF = 10_000, 200


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flat", list(FLAT))
def test_plain_modified_charges_on_flat_nodes(x64, flat):
    """q_hat of each flat node sums to its charge; the reference's XLA and
    Pallas (interpret mode) modified charges agree on each node."""
    degree = FIG4["degree"]
    pts, q, chunks, ptr, lo, hi, counts = flat_case(
        np.random.default_rng(1), torch.float64, degree, FLAT[flat])
    got = ops.modified_charges_ranged(pts, q, chunks, ptr, lo, hi,
                                      degree=degree, backend="torch")
    torch.testing.assert_close(got.sum(1), node_charges(q, counts),
                               rtol=1e-12, atol=1e-12)
    # the reference's dense form: each node's particles, padded with its
    # first particle at charge 0
    m = max(counts)
    bounds = np.append(np.concatenate([[0], np.cumsum(counts[:-2])]), 0)
    idx = np.minimum(bounds[:, None] + np.arange(m), len(q) - 1)
    valid = np.arange(m) < np.asarray(counts)[:, None]
    idx = np.where(valid, idx, bounds[:, None])
    jpts = jnp.asarray(pts.numpy()[idx])
    jq = jnp.asarray(np.where(valid, q.numpy()[idx], 0.0))
    for backend in ("xla", "pallas_interpret"):
        want = jops.modified_charges(jpts, jq, jnp.asarray(lo.numpy()),
                                     jnp.asarray(hi.numpy()), degree=degree,
                                     backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-12, err_msg=backend)


@pytest.fixture(scope="module")
def sheet():
    r = np.random.default_rng(2020)
    x = np.zeros((SHEET_N, 3))
    x[:, :2] = r.uniform(-1, 1, (SHEET_N, 2))
    return x, r.uniform(-1, 1, SHEET_N)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("build", ["host", "device"])
def test_sheet_matches_reference(x64, sheet, build):
    """The 10,000-point sheet: approximation-lane nodes of more than
    (n+1)^3 particles, every one flat in z; phi and forces equal the
    reference's (the port's plain versions, the reference's XLA path)."""
    check_sheet(sheet, build_backend=build)


def test_sheet_hierarchical_matches_reference(x64, sheet):
    """The same sheet with the hierarchical precompute (host build: the
    internal nodes' q_hat from their children's through the restriction
    rows of `bary_terms`, flat in z as the leaves are)."""
    check_sheet(sheet, build_backend="host", precompute="hierarchical")


def check_sheet(sheet, **opts):
    x, q = sheet
    kw = dict(leaf_size=SHEET_LEAF, dtype="float64", **opts, **FIG4)
    plan = TreecodeSolver(TreecodeConfig(backend="torch", **kw),
                          device="cpu").plan(x)
    jplan = JSolver(JConfig(backend="xla", **kw)).plan(x, nranks=1)
    a = plan.inner.arrays
    approx = a["approx_idx"]
    swept = torch.unique(approx[approx >= 0])
    assert swept.numel() > 0
    lo, hi = a["node_lo"][swept], a["node_hi"][swept]
    assert (lo[:, 2] == hi[:, 2]).all()              # flat in z
    ch = a["mc_chunks"].long()              # (node, begin, end) rows
    count = torch.zeros(a["node_lo"].shape[0], dtype=torch.long).index_add_(
        0, ch[:, 0], ch[:, 2] - ch[:, 1])
    assert (count[swept] > (FIG4["degree"] + 1) ** 3).all()
    _close(plan.execute(q).numpy(), jplan.execute(jnp.asarray(q)))
    phi, f = plan.potential_and_forces(q)
    jphi, jf = jplan.potential_and_forces(jnp.asarray(q))
    _close(phi.numpy(), jphi)
    _close(f.numpy(), jf)

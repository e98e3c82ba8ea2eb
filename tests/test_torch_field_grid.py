"""The grid field kernel's plain twin, and the force sweep through it.

`batch_cluster_field_grid_plain` is the approximation lane's field over
each cluster's tensor-product Chebyshev grid in the CUDA kernel's factored
form (per-axis displacement tables, row and plane sums). It is held
against `batch_cluster_field_plain` on the `cheby.cluster_grid` points of
the same boxes: degrees 1-14, free space, a periodic box and a box whose
x edge puts targets at minimum-image ties, Coulomb and Yukawa, Kahan,
target counts, -1 sentinels, targets exactly on grid points, a cluster of
zero width and a scratch node (q_hat 0). `potential_and_forces` on the
CPU, whose approximation lane now runs the twin, is held against
`repro`'s forces on the same numpy inputs. CUDA-marked tests hold the
kernel against the twin on the card.

Tolerances, per entry, `mag` being the sum of the terms' magnitudes (the
`magnitude=True` sweep): the two forms differ in the rounding of r^2 and
in the order of the sums. f64: rtol 1e-12 plus 1e-13 mag (a gradient
component sums signed terms and can cancel towards 0). f32: phi rtol 2e-4
plus 1e-5 mag, each gradient component 1e-5 mag (`chip_smoke.py`'s
GRAD_K). The forces: f64 rtol 1e-10 with an absolute floor of 1e-12
times the largest |value|, f32 relative 2-norm <= 1e-5 (as
`tests/test_torch_forces.py`).
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.core.space import PeriodicBox as JBox
from repro_torch.core import cheby
from repro_torch.core import eval as teval
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.potentials import coulomb, yukawa
from repro_torch.core.space import FREE, PeriodicBox
from repro_torch.kernels import batch_cluster as bcm
from repro_torch.kernels import ops

L = 2.0
TIE_LEN = 1.7778428792953491
SPACES = {"free": FREE,
          "periodic": PeriodicBox((1.5, 2.0, 1.7), origin=(-0.75, -1, -0.85)),
          "tie": PeriodicBox((TIE_LEN, 7.0, 7.0))}
#: per-entry bars (module docstring), by itemsize: rtol of (phi, gx, gy,
#: gz), and k, the share of the terms' magnitudes
BARS = {8: dict(rtol=(1e-12,) * 4, k=1e-13),
        4: dict(rtol=(2e-4, 0.0, 0.0, 0.0), k=1e-5)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps OpenMP from spinning
    against the other test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _ties(length):
    """f32 x displacements near a minimum-image tie of edge `length`."""
    Lf = np.float32(length)
    ds = []
    for h in (0.5, -0.5, 1.5):
        lo = hi = np.float32(h * float(Lf))
        ds.append(lo)
        for _ in range(16):
            lo = np.nextafter(lo, np.float32(-9))
            hi = np.nextafter(hi, np.float32(9))
            ds += [lo, hi]
    return np.array(ds, np.float32)


def _case(seed, degree, space, dtype, device="cpu", B=3, S=5, NB=40, C=6):
    """Ragged grid-field inputs: (idx, tgt, nodes, q_hat, grid points,
    tgt_count). Cluster 0 holds exact hits (tie box: zero width in x, the
    targets of row 1 at tie displacements from it), cluster 1 has zero
    width in z, the last cluster is a scratch node (unit box, q_hat 0);
    row 0 is all -1, every row has an interior -1."""
    r = np.random.default_rng(seed)
    n1 = degree + 1
    lo = r.uniform(-1, 0.5, (C, 3))
    hi = lo + r.uniform(0.1, 0.5, (C, 3))
    lo[-1], hi[-1] = 0.0, 1.0
    hi[1, 2] = lo[1, 2]
    if space is SPACES["tie"]:
        lo[0, 0] = hi[0, 0] = 0.0
    lo_t, hi_t = (torch.as_tensor(v, dtype=dtype, device=device)
                  for v in (lo, hi))
    nodes = ops._cluster_nodes(lo_t, hi_t, degree)
    pts = cheby.cluster_grid(lo_t, hi_t, degree)
    qlo = 0.0 if dtype == torch.float64 else -1.0   # f64: phi never cancels
    qh = torch.as_tensor(r.uniform(qlo, 1, (C, n1 ** 3)), dtype=dtype,
                         device=device)
    qh[-1] = 0.0
    tgt = torch.as_tensor(r.uniform(-1, 1, (B, NB, 3)), dtype=dtype,
                          device=device)
    tgt[-1, :3] = pts[0, [0, n1 ** 3 // 2, n1 ** 3 - 1]]       # exact hits
    idx = r.integers(-1, C, (B, S))
    idx[:, S // 2] = -1
    idx[0] = -1
    idx[-1, :2] = (0, C - 1)
    if space is SPACES["tie"]:
        ties = _ties(TIE_LEN)[:NB]
        tgt[1, :len(ties), 0] = torch.as_tensor(ties, dtype=dtype)
        idx[1, 0] = 0
    tc = torch.as_tensor([0, NB, NB - 7][:B], dtype=torch.int32,
                         device=device)
    return (torch.as_tensor(idx, dtype=torch.int32, device=device), tgt,
            nodes, qh, pts, tc)


def _assert_within(got, want, mag, what):
    bar = BARS[got.element_size()]
    rtol = torch.tensor(bar["rtol"], dtype=got.dtype, device=got.device)
    err = (got - want).abs()
    ok = err <= rtol * want.abs() + bar["k"] * mag
    assert bool(ok.all()), (f"{what}: max err {err.max().item():.3e}, "
                            f"{int((~ok).sum())} entries outside")


def test_cluster_nodes_are_the_grid_coordinates():
    """The nodes the grid kernel takes are, bitwise, the coordinates of
    `cluster_grid` (k3 fastest)."""
    r = np.random.default_rng(0)
    for dtype, degree in itertools.product((torch.float32, torch.float64),
                                           (1, 5, 8)):
        lo = torch.as_tensor(r.uniform(-1, 0, (4, 3)), dtype=dtype)
        hi = lo + torch.as_tensor(r.uniform(0.1, 1, (4, 3)), dtype=dtype)
        nodes = ops._cluster_nodes(lo, hi, degree)
        n1 = degree + 1
        grid = cheby.cluster_grid(lo, hi, degree).reshape(4, n1, n1, n1, 3)
        for axis, view in enumerate((nodes[:, 0, :, None, None],
                                     nodes[:, 1, None, :, None],
                                     nodes[:, 2, None, None, :])):
            assert torch.equal(grid[..., axis], view.expand(4, n1, n1, n1))


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("degree", list(bcm.GRID_DEGREES))
def test_grid_plain_matches_field_plain(degree, space):
    """The factored twin against the field's plain version on the grid
    points, both dtypes, Coulomb and Yukawa, Kahan and counts on and off;
    row 0 (all -1) and the slots past the counts are 0."""
    sp = SPACES[space]
    for dtype, kern, kahan, counts in itertools.product(
            (torch.float64, torch.float32), (coulomb(), yukawa(1.3)),
            (False, True), (False, True)):
        idx, tgt, nodes, qh, pts, tc = _case(degree, degree, sp, dtype)
        kw = dict(kernel=kern, space=sp, kahan=kahan,
                  tgt_count=tc if counts else None)
        got = bcm.batch_cluster_field_grid_plain(idx, tgt, nodes, qh, **kw)
        want = bcm.batch_cluster_field_plain(idx, tgt, pts, qh, **kw)
        mag = bcm.batch_cluster_field_plain(idx, tgt, pts, qh,
                                            magnitude=True, **kw)
        assert torch.isfinite(got).all()
        _assert_within(got, want, mag, f"{dtype} {kern.name} kahan={kahan} "
                                       f"counts={counts}")
        assert (got[0] == 0).all()
        if counts:
            assert (got[2, tc[2]:] == 0).all()


@pytest.mark.parametrize("degree", [1, 6, 14])
def test_grid_plain_magnitude_matches_field_plain(degree):
    """The twin's `magnitude=True` sweep is the field plain version's: the
    factored sums of magnitudes are the sums of the terms' magnitudes."""
    sp = SPACES["periodic"]
    idx, tgt, nodes, qh, pts, tc = _case(7, degree, sp, torch.float64)
    kw = dict(kernel=yukawa(0.9), space=sp, tgt_count=tc, magnitude=True)
    got = bcm.batch_cluster_field_grid_plain(idx, tgt, nodes, qh, **kw)
    want = bcm.batch_cluster_field_plain(idx, tgt, pts, qh, **kw)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0)
    assert (got[1] > 0).all()


def test_grid_plain_exact_hit_adds_nothing():
    """A target on a grid point: the hit adds exactly 0 to all four sums,
    so a lone grid point at the target gives 0."""
    for dtype, sp in itertools.product((torch.float32, torch.float64),
                                       (FREE, SPACES["periodic"])):
        lo = torch.full((1, 3), 0.25, dtype=dtype)
        nodes = ops._cluster_nodes(lo, lo, 1)           # one point, twice
        tgt = lo[None].clone()
        qh = torch.ones((1, 8), dtype=dtype)
        out = bcm.batch_cluster_field_grid_plain(
            torch.zeros((1, 1), dtype=torch.int32), tgt, nodes, qh,
            kernel=coulomb(), space=sp)
        assert (out == 0).all()


def test_swept_pairs_grid_geometry():
    """The grid kernel sweeps (n+1)^3 points a cluster in tiles of
    `grid_tile` targets, with no rounding of the points."""
    idx = torch.tensor([[0, -1, 1], [1, 1, -1]], dtype=torch.int32)
    tc = torch.tensor([65, 0], dtype=torch.int32)
    n1 = 9
    tile = bcm.grid_tile(4, n1)
    assert (tile, bcm.grid_tile(8, n1), bcm.grid_tile(4, 10)) == (64, 32, 32)
    geo = bcm.swept_pairs(idx, 300, n1 ** 3, tc, tile=tile, unroll=1)
    assert geo == {"pairs": float(2 * tile * 2 * n1 ** 3), "tiles": 2,
                   "tiles_launched": 2 * 5}


def test_grid_wrapper_refuses_cpu_tensors():
    """On CPU tensors the CUDA entry raises (no fallback), and
    backend="cuda" refuses them before that."""
    idx, tgt, nodes, qh, _, tc = _case(1, 2, FREE, torch.float32)
    par = torch.zeros(1)
    with pytest.raises(ValueError, match="CUDA device"):
        bcm.batch_cluster_field_grid_cuda(idx, par, tgt, nodes, qh,
                                          kernel=coulomb())
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.batch_cluster_field_grid(idx, tgt, nodes, qh, kernel=coulomb(),
                                     backend="cuda")


def _solvers(space, kernel, skin, degree, dtype_np):
    theta, leaf = (0.7, 32) if space == "free" else (0.8, 16)
    opts = dict(theta=theta, degree=degree, leaf_size=leaf, kernel=kernel,
                skin=skin)
    if kernel == "yukawa":
        opts["kernel_params"] = {"kappa": 0.8}
    periodic = space == "periodic"
    port = TreecodeSolver(TreecodeConfig(
        space=PeriodicBox((L, L, L)) if periodic else None, **opts),
        device="cpu")
    ref = JSolver(JConfig(space=JBox((L, L, L)) if periodic else None,
                          backend="xla", **opts))
    r = np.random.default_rng(0)
    x = r.uniform(0, L, (1000, 3)).astype(dtype_np)
    q = r.uniform(-1, 1, 1000).astype(dtype_np)
    return port, ref, x, q


@pytest.mark.parametrize("space,kernel,skin,degree", [
    ("free", "coulomb", 0.0, 3), ("free", "yukawa", 0.03, 2),
    ("periodic", "coulomb", 0.03, 2), ("periodic", "yukawa", 0.0, 2)])
def test_forces_through_grid_lane_match_reference_f64(x64, monkeypatch,
                                                      space, kernel, skin,
                                                      degree):
    """`potential_and_forces` sends the approximation lane through the
    grid field op (one call, on nodes (C, 3, n+1)) and matches `repro`."""
    calls = []
    grid_op = teval._LANE_OPS["field"]["approx"]

    def spy(idx, tgt, nodes, *a, **kw):
        calls.append(tuple(nodes.shape))
        return grid_op(idx, tgt, nodes, *a, **kw)
    monkeypatch.setitem(teval._LANE_OPS["field"], "approx", spy)
    port, ref, x, q = _solvers(space, kernel, skin, degree, np.float64)
    plan = port.plan(x)
    assert (plan.arrays["approx_idx"] >= 0).any()
    phi, F = plan.potential_and_forces(q)
    assert calls == [(plan.arrays["node_lo"].shape[0], 3, degree + 1)]
    jphi, jF = ref.plan(x, nranks=1).potential_and_forces(q)
    for got, want in ((phi.numpy(), jphi), (F.numpy(), jF)):
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max())


def test_forces_through_grid_lane_match_reference_f32():
    port, ref, x, q = _solvers("free", "coulomb", 0.02, 3, np.float32)
    plan = port.plan(x)
    assert (plan.arrays["approx_idx"] >= 0).any()
    phi, F = plan.potential_and_forces(q)
    jphi, jF = ref.plan(x, nranks=1).potential_and_forces(q)
    for got, want in ((phi.numpy(), jphi), (F.numpy(), jF)):
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("space", ["free", "periodic", "tie"])
@pytest.mark.parametrize("kahan", [False, True])
def test_grid_field_kernel_matches_plain(cuda_device, dtype, space, kahan):
    """The grid field kernel against its twin at degrees 1-14, with
    counts, sentinels, exact hits, the scratch node and (tie box) the
    minimum-image ties: each entry within the module's bars; the rows
    past the counts and the all -1 row are 0; one launch a call."""
    sp = SPACES[space]
    for degree, kern in itertools.product(bcm.GRID_DEGREES,
                                          (coulomb(), yukawa(0.5))):
        idx, tgt, nodes, qh, _, tc = _case(degree, degree, sp, dtype,
                                           cuda_device, NB=150)
        kw = dict(kernel=kern, space=sp, kahan=kahan, tgt_count=tc)
        before = bcm.GRID_FIELD_LAUNCHES
        got = ops.batch_cluster_field_grid(idx, tgt, nodes, qh, **kw)
        assert bcm.GRID_FIELD_LAUNCHES == before + 1
        want = ops.batch_cluster_field_grid(idx, tgt, nodes, qh,
                                            backend="torch", **kw)
        mag = bcm.batch_cluster_field_grid_plain(idx, tgt, nodes, qh,
                                                 magnitude=True, **kw)
        assert torch.isfinite(got).all()
        _assert_within(got, want, mag, f"degree {degree} {kern.name}")
        assert (got[0] == 0).all() and (got[2, tc[2]:] == 0).all()

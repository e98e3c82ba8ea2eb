"""User kernels through their user libraries on the card (marked `cuda`).

A kernel that is neither Coulomb nor Yukawa runs through the three
batch-cluster CUDA sources built with the code generated from its torch
function (`kernels/codegen.py`). Each test asks the `cuda_device` fixture
for the device and skips where there is none; the CPU holds the generated
code (`tests/test_torch_codegen.py`) and the plain path against the JAX
package (`tests/test_torch_user_kernels.py`). The sweep at the main
path's shapes is phase 20 of `chip_smoke.py` (`tools/chip_phases.py
20`)."""
import numpy as np
import pytest
import torch

from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.potentials import Kernel
from repro_torch.core.space import FREE, PeriodicBox
from repro_torch.kernels import batch_cluster as bcm
from repro_torch.kernels import ops


def _plummer(r2, params):
    (eps2,) = params
    return (r2 + eps2) ** -0.5


def _gauss(r2, params):
    (alpha,) = params
    return torch.exp(-alpha * r2)


PLUMMER = Kernel("plummer", _plummer, (1e-2,), ("eps2",))
GAUSS = Kernel("gaussian_test", _gauss, (2.0,))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(rng, dtype, dev, B=4, S=6, NB=200, C=9, m=300):
    qlo = -1.0 if dtype == torch.float32 else 0.0
    tgt = rng.uniform(-1, 1, (B, NB, 3))
    src = rng.uniform(-1, 1, (C, m, 3))
    tgt[-1, :3] = src[0, :3]                   # exact hits
    idx = rng.integers(-1, C, (B, S))
    idx[:, 2] = -1                             # interior sentinels
    idx[0] = -1                                # an all-empty row
    idx[-1, 0] = 0
    t = [torch.as_tensor(a, dtype=dtype, device=dev)
         for a in (tgt, src, rng.uniform(qlo, 1, (C, m)))]
    return torch.as_tensor(idx, dtype=torch.int32, device=dev), t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
def test_user_library_kernels_match_plain(cuda_device, dtype, periodic,
                                          kahan):
    """The potential, field and grid field kernels of two user kernels
    against their plain versions (phase 2's tolerances, gradients to 1e-5
    / 1e-13 of their terms' magnitudes); exact hits add 0."""
    from repro_torch.core import cheby
    rng = np.random.default_rng(3)
    dev = cuda_device
    it, t = _case(rng, dtype, dev)
    space = PeriodicBox((1.5, 2.0, 1.7)) if periodic else FREE
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (1e-12, 0.0)
    k = 1e-5 if dtype == torch.float32 else 1e-13
    for kern in (PLUMMER, GAUSS):
        kw = dict(kernel=kern, space=space, kahan=kahan)
        before = bcm.LAUNCHES
        got = ops.batch_cluster_eval(it, *t, **kw)
        assert bcm.LAUNCHES == before + 1
        want = ops.batch_cluster_eval(it, *t, backend="torch", **kw)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        before = bcm.FIELD_LAUNCHES
        got = ops.batch_cluster_field(it, *t, **kw)
        assert bcm.FIELD_LAUNCHES == before + 1
        want = ops.batch_cluster_field(it, *t, backend="torch", **kw)
        mag = bcm.batch_cluster_field_plain(it, *t, magnitude=True, **kw)
        torch.testing.assert_close(got[..., 0], want[..., 0], rtol=rtol,
                                   atol=atol)
        assert ((got[..., 1:] - want[..., 1:]).abs()
                <= k * mag[..., 1:]).all()
        assert (got[0] == 0).all() and torch.isfinite(got).all()
        degree = 4
        lo = torch.as_tensor(rng.uniform(-1, 0.5, (5, 3)), dtype=dtype,
                             device=dev)
        hi = lo + 0.3
        nodes = ops._cluster_nodes(lo, hi, degree).contiguous()
        qh = torch.as_tensor(rng.uniform(0, 1, (5, (degree + 1) ** 3)),
                             dtype=dtype, device=dev)
        gidx = it.clamp(max=4)
        before = bcm.GRID_FIELD_LAUNCHES
        got = ops.batch_cluster_field_grid(gidx, t[0], nodes, qh, **kw)
        assert bcm.GRID_FIELD_LAUNCHES == before + 1
        want = ops.batch_cluster_field_grid(gidx, t[0], nodes, qh,
                                            backend="torch", **kw)
        pts = cheby.cluster_grid(lo, hi, degree)
        mag = bcm.batch_cluster_field_plain(gidx, t[0], pts, qh,
                                            magnitude=True, **kw)
        torch.testing.assert_close(got[..., 0], want[..., 0], rtol=rtol,
                                   atol=atol)
        assert ((got[..., 1:] - want[..., 1:]).abs()
                <= k * mag[..., 1:]).all()
    # a lone particle meeting itself adds exactly 0 to all four outputs
    x = torch.zeros((1, 1, 3), dtype=dtype, device=dev)
    one = torch.ones((1, 1), dtype=dtype, device=dev)
    it1 = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    assert (ops.batch_cluster_field(it1, x, x.clone(), one, kernel=PLUMMER,
                                    space=space) == 0).all()


@pytest.mark.cuda
def test_solver_with_user_kernel_on_cuda(cuda_device):
    """TreecodeSolver with a user kernel on the card: execute and forces
    through the user libraries (the counters rise), against the plain
    path of the same plan (backend='torch') on the card."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (6000, 3))
    q = rng.uniform(-1, 1, 6000)
    kw = dict(theta=0.7, degree=5, leaf_size=200, kernel=PLUMMER,
              dtype="float64")
    plan = TreecodeSolver(TreecodeConfig(**kw)).plan(x)
    ref = TreecodeSolver(TreecodeConfig(backend="torch", **kw)).plan(x)
    bcm.LAUNCHES = bcm.FIELD_LAUNCHES = bcm.GRID_FIELD_LAUNCHES = 0
    phi = plan.execute(q)
    _, force = plan.potential_and_forces(q)
    assert (bcm.LAUNCHES, bcm.FIELD_LAUNCHES,
            bcm.GRID_FIELD_LAUNCHES) == (2, 1, 1)
    want = ref.execute(q)     # signed charges: phi near 0 takes atol
    torch.testing.assert_close(phi, want, rtol=1e-12,
                               atol=1e-12 * want.abs().max().item())
    _, want = ref.potential_and_forces(q)
    torch.testing.assert_close(force, want, rtol=1e-10,
                               atol=1e-12 * want.abs().max().item())


@pytest.mark.cuda
def test_solver_refuses_untaken_kernel_when_built(cuda_device):
    """A kernel the generator does not take raises NotImplementedError
    when the solver is built on the card, naming the op, not at its first
    launch; backend='torch' takes it."""
    bessel = Kernel("bessel", lambda r2, p: torch.special.bessel_j0(r2))
    with pytest.raises(NotImplementedError, match="bessel_j0"):
        TreecodeSolver(TreecodeConfig(kernel=bessel))
    TreecodeSolver(TreecodeConfig(kernel=bessel, backend="torch"))


@pytest.mark.cuda
def test_sharded_plan_with_user_kernel(cuda_device):
    """The sharded plan (nranks=2, ranks stacked on the card) with plummer
    against the single plan of the same points."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (8000, 3))
    q = torch.as_tensor(rng.uniform(-1, 1, 8000), device=cuda_device)
    solver = TreecodeSolver(TreecodeConfig(theta=0.7, degree=5,
                                           leaf_size=200, kernel=PLUMMER,
                                           dtype="float64"))
    single = solver.plan(x)
    sharded = solver.plan(x, nranks=2)
    phi1, f1 = single.potential_and_forces(q)
    phi2, f2 = sharded.potential_and_forces(q)
    rel = float((phi2 - phi1).norm() / phi1.norm())
    frel = float((f2 - f1).norm() / f1.norm())
    # two plans of the same accuracy: they differ by the approximation
    assert rel < 1e-5 and frel < 1e-4, (rel, frel)
    torch.testing.assert_close(sharded.execute(q), phi2, rtol=1e-6,
                               atol=1e-9)

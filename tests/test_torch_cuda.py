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
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tile = mcm._build.load("modified_charges", mcm._SIGNATURES).mc_tile(
        dtype.itemsize)
    splits = mcm.split_count(C, m, tile, sms)
    before = mcm.LAUNCHES
    got = ops.modified_charges(pts, q, lo, hi, degree=degree)
    # the split reduction is a launch of its own
    assert mcm.LAUNCHES == before + (2 if splits > 1 else 1)
    want = ops.modified_charges(pts, q, lo, hi, degree=degree,
                                backend="torch")
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=3e-3, atol=3e-4)
    else:
        torch.testing.assert_close(got, want, rtol=1e-10,
                                   atol=1e-12 * want.abs().max().item())

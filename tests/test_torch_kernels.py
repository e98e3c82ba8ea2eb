"""repro_torch kernels' plain versions vs the JAX reference's kernels.

The port's plain PyTorch batch-cluster and modified-charge functions are
held against `repro.kernels.ops` on both reference backends (the Pallas
bodies in interpret mode, and the XLA path) on identical numpy inputs,
at the tolerances of `tests/test_kernels.py`, and against the port's own
unfactored oracles (`repro_torch.kernels.ref`)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import potentials as jpot
from repro.core import space as jspace
from repro.kernels import ops as jops
from repro_torch.core import potentials as tpot
from repro_torch.core import space as tspace
from repro_torch.kernels import batch_cluster as tbc
from repro_torch.kernels import modified_charges as tmc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

KERNELS = [("coulomb", ()), ("yukawa", (0.5,))]
BACKENDS = ["pallas_interpret", "xla"]


def _kernels(name, params):
    kw = dict(zip(("kappa",), params))
    return jpot.get_kernel(name, **kw), tpot.get_kernel(name, **kw)


def _case(rng, B, S, NB, C, m, dtype, qlo=-1.0):
    tgt = rng.uniform(-1, 1, (B, NB, 3)).astype(dtype)
    src = rng.uniform(-1, 1, (C, m, 3)).astype(dtype)
    q = rng.uniform(qlo, 1, (C, m)).astype(dtype)
    idx = rng.integers(-1, C, (B, S)).astype(np.int32)
    idx[:, S // 2] = -1                       # interior sentinel
    return idx, tgt, src, q


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("B,S,NB,C,m", [
    (1, 1, 8, 1, 8),
    (3, 5, 16, 7, 32),
    (2, 4, 40, 3, 24),     # NB not a multiple of the reference's tile
])
def test_batch_cluster_plain_matches_reference(rng, backend, B, S, NB, C, m):
    case = _case(rng, B, S, NB, C, m, np.float32)
    for name, params in KERNELS:
        jk, tk = _kernels(name, params)
        want = jops.batch_cluster_eval(*_jax(*case), kernel=jk,
                                       backend=backend, target_tile=8)
        got = tops.batch_cluster_eval(*_torch(*case), kernel=tk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
        oracle = tref.ref_batch_cluster_eval(*_torch(*case), tk)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kahan", [False, True])
def test_batch_cluster_plain_f64_periodic(rng, x64, kahan):
    """f64, free and periodic space, the chunked path (Kahan) and the
    flat path, against both reference backends at rtol 1e-12. Positive
    charges: no entry cancels towards 0, where the summation orders of
    the two packages would differ by more than rtol."""
    case = _case(rng, 2, 3, 16, 4, 16, np.float64, qlo=0.0)
    tb = tspace.PeriodicBox((1.3, 1.1, 1.7))
    jb = jspace.PeriodicBox((1.3, 1.1, 1.7))
    for ts, js in ((tspace.FREE, jspace.FREE), (tb, jb)):
        for name, params in KERNELS:
            jk, tk = _kernels(name, params)
            got = tops.batch_cluster_eval(*_torch(*case), kernel=tk,
                                          space=ts, kahan=kahan)
            for backend in BACKENDS:
                want = jops.batch_cluster_eval(
                    *_jax(*case), kernel=jk, space=js, backend=backend,
                    target_tile=16, kahan=kahan)
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-12)


def test_batch_cluster_plain_chunked_path_and_kahan(rng, monkeypatch):
    """Force 2-row batch chunks of the slot loop (what bounds memory at
    10^6 on the card) and compare with the reference's XLA path and the
    Kahan reference body."""
    case = _case(rng, 5, 8, 16, 8, 64, np.float32)
    _, tk = _kernels("coulomb", ())
    jk, _ = _kernels("coulomb", ())
    flat = jops.batch_cluster_eval(*_jax(*case), kernel=jk, backend="xla")
    monkeypatch.setattr(tbc, "_PAIR_BUDGET", 2 * 16 * 64)  # 2-row chunks
    chunked = tops.batch_cluster_eval(*_torch(*case), kernel=tk)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(flat), rtol=2e-5,
                               atol=2e-5)
    kahan = tops.batch_cluster_eval(*_torch(*case), kernel=tk, kahan=True)
    want = jops.batch_cluster_eval(*_jax(*case), kernel=jk, kahan=True,
                                   backend="pallas_interpret",
                                   target_tile=16)
    np.testing.assert_allclose(kahan.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_batch_cluster_plain_matmul_r2(rng):
    idx, tgt, src, q = _case(rng, 1, 24, 8, 24, 8, np.float32)
    src = src + np.float32(4.0)               # MAC-separated geometry
    jk, tk = _kernels("coulomb", ())
    got = tops.batch_cluster_eval(*_torch(idx, tgt, src, q), kernel=tk,
                                  r2_mode="matmul")
    for backend in BACKENDS:
        want = jops.batch_cluster_eval(*_jax(idx, tgt, src, q), kernel=jk,
                                       backend=backend, target_tile=8,
                                       r2_mode="matmul")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_batch_cluster_all_empty_and_coincident(rng):
    _, tk = _kernels("coulomb", ())
    idx = torch.full((2, 3), -1, dtype=torch.int32)
    _, tgt, src, q = _case(rng, 2, 3, 8, 2, 8, np.float32)
    got = tops.batch_cluster_eval(idx, *_torch(tgt, src, q), kernel=tk)
    assert (got == 0).all()
    tgt = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]])
    src = torch.tensor([[[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    got = tops.batch_cluster_eval(torch.zeros((1, 1), dtype=torch.int32),
                                  tgt, src, torch.ones(1, 2), kernel=tk)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0, 0].item(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("C,m,degree", [(1, 8, 1), (3, 32, 2), (2, 100, 3)])
def test_modified_charges_plain_matches_reference(rng, backend, C, m,
                                                  degree):
    pts = rng.uniform(0, 1, (C, m, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (C, m)).astype(np.float32)
    lo, hi = pts.min(1), pts.max(1)       # min boxes: exact hits on corners
    want = jops.modified_charges(*_jax(pts, q, lo, hi), degree=degree,
                                 backend=backend, particle_tile=32)
    got = tops.modified_charges(*_torch(pts, q, lo, hi), degree=degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-3,
                               atol=3e-4)
    oracle = tref.ref_modified_charges(*_torch(pts, q, lo, hi), degree)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=3e-3,
                               atol=3e-4)


def test_modified_charges_exact_hits_f64(rng, x64):
    """Sources ON the Chebyshev nodes: the removable-singularity path."""
    from repro.core import cheby as jcheby
    degree = 4
    lo, hi = np.zeros((1, 3)), np.ones((1, 3))
    grid = np.asarray(jcheby.cluster_grid(jnp.asarray(lo[0]),
                                          jnp.asarray(hi[0]), degree))
    pts = np.concatenate([grid, rng.uniform(0, 1, (7, 3))])[None]
    q = rng.uniform(-1, 1, (1, pts.shape[1]))
    got = tops.modified_charges(*_torch(pts, q, lo, hi), degree=degree)
    assert torch.isfinite(got).all()
    for backend in BACKENDS:
        want = jops.modified_charges(*_jax(pts, q, lo, hi), degree=degree,
                                     backend=backend, particle_tile=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def test_modified_charges_reproduce_far_field():
    """Eq. 11 end to end in f64: sum_k G(x, s_k) qhat_k matches
    sum_j G(x, y_j) q_j for a well-separated target at degree 12."""
    rng = np.random.default_rng(8)
    pts = torch.as_tensor(rng.uniform(0, 1, (1, 64, 3)))
    q = torch.as_tensor(rng.uniform(-1, 1, (1, 64)))
    lo, hi = pts.amin(1), pts.amax(1)
    qhat = tops.modified_charges(pts, q, lo, hi, degree=12)
    x = torch.tensor([[5.0, 4.0, 3.0]], dtype=torch.float64)
    kern = tpot.coulomb()
    exact = (kern.pairwise(x, pts[0]) @ q[0]).item()
    approx = tref.ref_cluster_approx_potential(x, lo[0], hi[0], qhat[0],
                                               12, kern).item()
    assert abs(approx - exact) / abs(exact) < 1e-12


def test_modified_charges_center_padding_and_split_count():
    """Center-filled padding with q = 0 adds nothing (f32, degree 10,
    where an outside pad would cancel the denominator to 0)."""
    rng = np.random.default_rng(4)
    pts = torch.as_tensor(rng.uniform(0, 1, (2, 40, 3)), dtype=torch.float32)
    q = torch.as_tensor(rng.uniform(-1, 1, (2, 40)), dtype=torch.float32)
    lo, hi = pts.amin(1), pts.amax(1)
    base = tops.modified_charges(pts, q, lo, hi, degree=10)
    padded = torch.cat([pts, (0.5 * (lo + hi))[:, None].expand(2, 24, 3)], 1)
    qp = torch.cat([q, torch.zeros(2, 24)], 1)
    got = tops.modified_charges(padded, qp, lo, hi, degree=10)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the CUDA launch geometry: whole tiles, no empty split, ~2 blocks/SM
    assert tmc.split_count(1, 1 << 20, 256, 132) == 256
    assert tmc.split_count(512, 2048, 256, 132) == 1
    assert tmc.split_count(8, 1 << 17, 256, 132) == 32
    for c, m in ((1, 100), (3, 5000), (64, 1 << 14)):
        s = tmc.split_count(c, m, 128, 132)
        ntiles = -(-m // 128)
        per = -(-ntiles // s)
        assert 1 <= s <= ntiles and (s - 1) * per < ntiles


def test_cuda_backend_refuses_cpu_tensors():
    _, tk = _kernels("coulomb", ())
    idx = torch.zeros((1, 1), dtype=torch.int32)
    x = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tops.batch_cluster_eval(idx, x, x, torch.zeros(1, 8), kernel=tk,
                                backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.modified_charges(x, torch.zeros(1, 8), torch.zeros(1, 3),
                              torch.ones(1, 3), degree=2, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        tops.batch_cluster_eval(idx, x, x, torch.zeros(1, 8), kernel=tk,
                                backend="xla")
    user = tpot.Kernel("soft", lambda r2, p: 1.0 / torch.sqrt(r2 + 1.0))
    with pytest.raises(NotImplementedError, match="torch"):
        tbc.kernel_id(user)


def test_mac_gate_matches_reference(rng, x64):
    """The Verlet-skin runtime gate, free and periodic, bitwise."""
    from repro.kernels import ops as jo
    B, NB, M, S = 4, 8, 6, 5
    tgt = rng.uniform(-1, 1, (B, NB, 3))
    mask = rng.uniform(0, 1, (B, NB)) > 0.3
    mask[-1] = False                           # an empty batch row
    lo = rng.uniform(-3, 2, (M, 3))
    hi = lo + rng.uniform(0.05, 0.5, (M, 3))
    idx = rng.integers(-1, M, (B, S)).astype(np.int32)
    tb = tspace.PeriodicBox((4.0, 4.0, 4.0))
    jb = jspace.PeriodicBox((4.0, 4.0, 4.0))
    tbox = tops.batch_boxes(*_torch(tgt, mask))
    jbox = jo.batch_boxes(*_jax(tgt, mask))
    for a, b in zip(tbox, jbox):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for theta in (0.5, 0.9):
        for ts, js in ((tspace.FREE, jspace.FREE), (tb, jb)):
            got = tops.mac_gate(torch.as_tensor(idx), *tbox,
                                *_torch(lo, hi), theta=theta, space=ts)
            want = jo.mac_gate(jnp.asarray(idx), *jbox, *_jax(lo, hi),
                               theta=theta, space=js)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

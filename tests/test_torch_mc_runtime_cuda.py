"""The runtime-degree modified-charge kernels against their plain versions,
on the card.

Marked `cuda`: each test asks the `cuda_device` fixture for the device
and skips where there is none. From n+1 = 16 the forward and the
transposed modified charges run their runtime-degree kernels; in f64 they
contract on the f64 tensor cores (`mma.sync`) while their tables fit (the
transpose to n+1 = 20, the forward to n+1 = 304), in f32 and past those
with FFMA. The cases cover n+1 in {16, 17, 24, 25, 33} in f32 and f64,
and n+1 = 9 with the runtime kernels forced; the transpose also n+1 = 20,
21 and 37 (the f64 FFMA kernel on both sides of the tensor cores' edge),
and the f64 forward n+1 = 305 (its FFMA kernel):

- ragged node ranges (`test_torch_cuda.ranged_case`): nodes without
  particles, a chunk of one particle, chunks of `CHUNK` particles and
  counts that are no multiple of the tile or of the mma's k, exact hits
  on the Chebyshev nodes, and a last node spanning the others;
- a particle far outside its node (each row's terms cancel: den = 0,
  so it adds 0);
- nodes flat in a dimension (`test_torch_flat_kernel.flat_case`: every
  particle hits all n+1 coincident nodes there, a multi-hit row);
- W = 3 stacked systems for the forward.

Each result is held to its plain version: the forward at rtol 1e-10 and
atol 1e-12 max|q_hat| in f64, rtol 3e-3 and atol 3e-4 max|q_hat| in f32;
the transpose per entry within MCT_K times its sum of the terms'
magnitudes (1e-13 f64, 1e-5 f32). Two calls are bitwise equal. The
fragment-layout probe holds both f64 mma shapes' fragment positions to a
plain product, and the division probe the rows' branch-free division to
the IEEE quotient. No JAX here (`tests/test_torch_high_degree.py` holds the
plain path to the reference)."""
import numpy as np
import pytest
import torch

from repro_torch.core import cheby
from repro_torch.kernels import modified_charges as mcm
from repro_torch.kernels import ops
from test_torch_cuda import ranged_case
from test_torch_flat_kernel import flat_case

#: n+1 of the cases (degrees 15, 16, 23, 24, 32), and 9 forced.
N1S = [16, 17, 24, 25, 33, 9]
#: The transpose's: also the last n+1 on the f64 tensor cores (20), the
#: first past them (21), and 37.
T_N1S = N1S + [20, 21, 37]
#: Per entry of the transpose: MCT_K of `chip_smoke.py` (phase 14).
MCT_K = {4: 1e-5, 8: 1e-13}
#: (rows, k) of the f64 mma shapes the probe takes: the transpose's
#: m16n8k4 and the forward's m16n8k8.
SHAPES = {1684: (16, 4), 1688: (16, 8)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lib():
    return mcm._build.load("modified_charges", mcm._SIGNATURES)


def _cases(rng, dtype, degree, dev):
    """(name, pts, q, chunks, chunk_ptr, lo, hi) of the ranged and the
    flat case, a particle of the ranged case moved far outside its node."""
    tile = _lib().mc_tile(dtype.itemsize, degree + 1)
    pts, q, chunks, ptr, lo, hi = ranged_case(rng, dtype, degree, dev, tile)
    pts[-5] = 1e30                  # den = 0 in its own node
    flat = flat_case(rng, dtype, degree, (2,), dev)[:6]
    return [("ranged", pts, q, chunks, ptr, lo, hi), ("flat", *flat)]


def _forced(n1):
    return n1 <= 15


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_mma_fragment_probe(cuda_device, shape):
    """One f64 mma through the kernels' fragment positions: D = A B."""
    rows, k = SHAPES[shape]
    rng = np.random.default_rng(shape)
    a = torch.as_tensor(rng.uniform(-1, 1, (rows, k)), device=cuda_device)
    b = torch.as_tensor(rng.uniform(-1, 1, (k, 8)), device=cuda_device)
    d = torch.full((rows, 8), float("nan"), dtype=torch.float64,
                   device=cuda_device)
    rc = _lib().mc_mma_probe(a.data_ptr(), b.data_ptr(), d.data_ptr(), shape,
                             torch.cuda.current_stream().cuda_stream)
    mcm._build.check(rc, "mc_mma_probe")
    torch.cuda.synchronize()
    torch.testing.assert_close(d, a @ b, rtol=1e-14, atol=1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_division_is_ieee(cuda_device, dtype):
    """The rows' branch-free division (`div_fast`) is the IEEE quotient,
    bit for bit, wherever the kernels take it (`div_fast_ok`): weights
    +-1 and +-1/2 over divisors of every magnitude in its range, and the
    weights over coordinate differences near an exact hit."""
    rng = np.random.default_rng(dtype.itemsize)
    n = 1 << 20
    top = 100 if dtype == torch.float32 else 900
    a = rng.choice([1.0, -1.0, 0.5, -0.5], n)
    b = rng.uniform(1, 2, n) * np.exp2(rng.integers(-top, top, n))
    b[: n // 4] = rng.uniform(-1, 1, n // 4) - rng.uniform(-1, 1, n // 4)
    b *= rng.choice([1.0, -1.0], n)
    a, b = (torch.as_tensor(v, dtype=dtype, device=cuda_device)
            for v in (a, b))
    q = torch.empty_like(a)
    rc = _lib().mc_div_probe(a.data_ptr(), b.data_ptr(), q.data_ptr(), n,
                             dtype.itemsize,
                             torch.cuda.current_stream().cuda_stream)
    mcm._build.check(rc, "mc_div_probe")
    ok = (b.abs() >= 2.0 ** -top) & (b.abs() <= 2.0 ** top)
    assert ok[n // 4:].all()
    want = torch.where(ok, a / b, torch.zeros_like(a))
    assert torch.equal(q, want), int((q != want).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n1", N1S)
def test_runtime_forward_matches_plain(cuda_device, dtype, n1):
    degree, dev = n1 - 1, cuda_device
    rng = np.random.default_rng(n1)
    f32 = dtype == torch.float32
    rtol, floor = (3e-3, 3e-4) if f32 else (1e-10, 1e-12)
    for name, *args in _cases(rng, dtype, degree, dev):
        kw = dict(degree=degree, _runtime=_forced(n1))
        nodes = ops._cluster_nodes(args[4], args[5], degree).contiguous()
        w = cheby.bary_weights_1d(degree, dtype, dev)
        call = (args[0], args[1], args[2].to(torch.int32),
                args[3].to(torch.int32), nodes, w)
        before = (mcm.LAUNCHES, mcm.RUNTIME_LAUNCHES)
        got = mcm.modified_charges_ranged_cuda(*call, **kw)
        assert (mcm.LAUNCHES - before[0],
                mcm.RUNTIME_LAUNCHES - before[1]) == (2, 1), name
        again = mcm.modified_charges_ranged_cuda(*call, **kw)
        want = mcm.modified_charges_ranged_plain(*call, degree)
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=floor * want.abs().max().item(),
                                   msg=f"{name} n+1={n1} {dtype}")
        assert torch.equal(got, again), f"{name}: two calls differ"
        if name == "ranged":
            assert (got[0] == 0).all() and (got[9] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n1", N1S)
def test_runtime_forward_systems_axis(cuda_device, dtype, n1):
    """W = 3 systems in one pair of launches, each its own plain version."""
    degree, dev, w = n1 - 1, cuda_device, 3
    rng = np.random.default_rng(100 + n1)
    f32 = dtype == torch.float32
    rtol, floor = (3e-3, 3e-4) if f32 else (1e-10, 1e-12)
    _, pts, q, chunks, ptr, lo, hi = _cases(rng, dtype, degree, dev)[0]
    qs = torch.stack([q] + [torch.as_tensor(rng.uniform(-1, 1, q.shape),
                                            dtype=dtype, device=dev)
                            for _ in range(w - 1)])
    nodes = ops._cluster_nodes(lo, hi, degree)
    call = (torch.stack([pts] * w), qs, torch.stack([chunks.int()] * w),
            torch.stack([ptr.int()] * w),
            torch.stack([nodes] * w).contiguous(),
            cheby.bary_weights_1d(degree, dtype, dev))
    before = mcm.RUNTIME_LAUNCHES
    got = mcm.modified_charges_ranged_cuda(*call, degree,
                                           _runtime=_forced(n1))
    assert mcm.RUNTIME_LAUNCHES == before + 1
    want = mcm.modified_charges_ranged_plain(*call, degree)
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=floor * want.abs().max().item())


@pytest.mark.cuda
def test_runtime_forward_f64_past_the_tensor_cores(cuda_device):
    """At n+1 = 305 the f64 forward's tensor-core tables pass their budget
    even at one k-step a tile, so it runs its FFMA kernel: one node, a
    chunk of 7 particles with an exact hit in every dimension, against its
    plain version; bitwise equal calls. (No den = 0 row: at this n+1 the
    plain version's blocked sum of a far particle's row leaves a rounding
    residue where the kernel's sum in k order gives 0.)"""
    n1, dev, dtype = 305, cuda_device, torch.float64
    degree = n1 - 1
    rng = np.random.default_rng(n1)
    lo = torch.as_tensor(rng.uniform(-1, 0, (1, 3)), dtype=dtype, device=dev)
    hi = lo + torch.as_tensor(rng.uniform(0.3, 1, (1, 3)), dtype=dtype,
                              device=dev)
    nodes = ops._cluster_nodes(lo, hi, degree).contiguous()
    pts = lo + (hi - lo) * torch.as_tensor(rng.uniform(0, 1, (7, 3)),
                                           dtype=dtype, device=dev)
    pts[0] = nodes[0, :, 101]       # an exact hit in each dimension
    q = torch.as_tensor(rng.uniform(-1, 1, 7), dtype=dtype, device=dev)
    chunks, ptr = mcm.chunk_table(np.array([0]), [7])
    call = (pts, q, torch.as_tensor(chunks, device=dev).int(),
            torch.as_tensor(ptr, device=dev).int(), nodes,
            cheby.bary_weights_1d(degree, dtype, dev))
    before = (mcm.LAUNCHES, mcm.RUNTIME_LAUNCHES)
    got = mcm.modified_charges_ranged_cuda(*call, degree)
    assert (mcm.LAUNCHES - before[0], mcm.RUNTIME_LAUNCHES - before[1]) == (
        2, 1)
    again = mcm.modified_charges_ranged_cuda(*call, degree)
    want = mcm.modified_charges_ranged_plain(*call, degree)
    torch.testing.assert_close(got, want, rtol=1e-10,
                               atol=1e-12 * want.abs().max().item())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n1", T_N1S)
def test_runtime_transpose_matches_plain(cuda_device, dtype, n1):
    """The transpose over a two-level tile table (every node a leaf under
    the last, which spans them), per entry within MCT_K of its terms'
    magnitudes; bitwise equal calls."""
    degree, dev = n1 - 1, cuda_device
    rng = np.random.default_rng(200 + n1)
    for name, pts, _, chunks, _, lo, hi in _cases(rng, dtype, degree, dev):
        m = lo.shape[0]
        parent = torch.full((m,), m - 1, device=dev)
        parent[-1] = -1
        tiles, chain = mcm.tile_table(chunks, parent, 2, pts.shape[0])
        qhat_bar = torch.as_tensor(rng.uniform(-1, 1, (m, n1 ** 3)),
                                   dtype=dtype, device=dev)
        args = (pts, qhat_bar, tiles, chain, lo.contiguous(),
                hi.contiguous(), degree)
        before = (mcm.TRANSPOSE_LAUNCHES, mcm.TRANSPOSE_RUNTIME_LAUNCHES)
        got = mcm.modified_charges_transpose_ranged_cuda(
            *args, _runtime=_forced(n1))
        assert (mcm.TRANSPOSE_LAUNCHES - before[0],
                mcm.TRANSPOSE_RUNTIME_LAUNCHES - before[1]) == (1, 1), name
        again = mcm.modified_charges_transpose_ranged_cuda(
            *args, _runtime=_forced(n1))
        want = mcm.modified_charges_transpose_ranged_plain(*args)
        mag = mcm.modified_charges_transpose_ranged_plain(*args,
                                                          magnitude=True)
        assert torch.isfinite(got).all(), name
        err = (got - want).abs()
        bad = err > MCT_K[dtype.itemsize] * mag
        assert not bad.any(), (f"{name} n+1={n1} {dtype}: {int(bad.sum())} "
                               f"entries, max abs err {err.max().item():.3e}")
        assert torch.equal(got, again), f"{name}: two calls differ"

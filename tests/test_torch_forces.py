"""Forces: the port's field path against `repro`'s forces on the same inputs.

`SingleDevicePlan.potential_and_forces` on ``device="cpu"`` (the field
kernel's plain version) against `repro`'s `potential_and_forces` on
``backend="xla"`` (three forward JVPs), free and periodic, Coulomb and
Yukawa, skin 0 and > 0, Kahan and the matmul r^2; against finite
differences and a two-body antisymmetry check; exact hits give zero
gradients; and `batch_cluster_field_plain` against `torch.func` of
`batch_cluster_eval_plain`.

Tolerances: f64 rtol 1e-10 with an absolute floor of 1e-12 times the
largest |value| (a force component or phi sums signed terms and can
cancel towards 0, where only the absolute rounding of the large terms
is left); f32 relative 2-norm <= 1e-5."""
import itertools

import numpy as np
import pytest
import torch

from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.core.space import PeriodicBox as JBox
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.direct import direct_field, direct_oracle_f64
from repro_torch.core.potentials import Kernel, coulomb, yukawa
from repro_torch.core.space import FREE, PeriodicBox
from repro_torch.kernels import batch_cluster as bcm
from repro_torch.kernels import ops

L = 2.0



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps OpenMP from spinning
    against the other test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _particles(seed, n, dtype=np.float64):
    r = np.random.default_rng(seed)
    return (r.uniform(0, L, (n, 3)).astype(dtype),
            r.uniform(-1, 1, n).astype(dtype))


def _close_f64(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    floor = 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=floor,
                               err_msg=what)


# (theta, degree, leaf_size): the periodic box needs small clusters for
# fold-free approximations to exist at these N
SETTINGS = {"free": (0.7, 3, 32), "periodic": (0.8, 2, 16)}


def _pair(space, kernel, skin, kahan=False, approx_r2="diff"):
    """(port solver, reference solver) on the same configuration."""
    theta, degree, leaf = SETTINGS[space]
    opts = dict(theta=theta, degree=degree, leaf_size=leaf, kernel=kernel,
                skin=skin, kahan=kahan, approx_r2=approx_r2)
    if kernel == "yukawa":
        opts["kernel_params"] = {"kappa": 0.8}
    periodic = space == "periodic"
    port = TreecodeSolver(TreecodeConfig(
        space=PeriodicBox((L, L, L)) if periodic else None, **opts),
        device="cpu")
    ref = JSolver(JConfig(space=JBox((L, L, L)) if periodic else None,
                          backend="xla", **opts))
    return port, ref


# (space, kernel, skin, kahan, approx_r2)
F64_CASES = [
    ("free", "coulomb", 0.0, False, "diff"),
    ("free", "yukawa", 0.03, True, "diff"),
    ("free", "coulomb", 0.0, False, "matmul"),
    ("periodic", "coulomb", 0.03, False, "diff"),
    ("periodic", "yukawa", 0.0, True, "diff"),
]


@pytest.mark.parametrize("space,kernel,skin,kahan,approx_r2", F64_CASES)
def test_forces_match_reference_f64(x64, space, kernel, skin, kahan,
                                    approx_r2):
    x, q = _particles(0, 1000)
    port, ref = _pair(space, kernel, skin, kahan, approx_r2)
    plan = port.plan(x)
    assert (plan.arrays["approx_idx"] >= 0).any()
    phi, F = plan.potential_and_forces(q)
    assert phi.dtype == torch.float64 and F.shape == (1000, 3)
    jphi, jF = ref.plan(x, nranks=1).potential_and_forces(q)
    _close_f64(phi.numpy(), jphi, "phi")
    _close_f64(F.numpy(), jF, "forces")
    # the field's phi is execute's phi
    _close_f64(phi.numpy(), plan.execute(q).numpy(), "phi vs execute")


@pytest.mark.parametrize("space,kernel,approx_r2",
                         [("free", "coulomb", "matmul"),
                          ("periodic", "yukawa", "diff")])
def test_forces_match_reference_f32(space, kernel, approx_r2):
    x, q = _particles(1, 1000, np.float32)
    port, ref = _pair(space, kernel, 0.02, approx_r2=approx_r2)
    phi, F = port.plan(x).potential_and_forces(q)
    assert F.dtype == torch.float32
    jphi, jF = ref.plan(x, nranks=1).potential_and_forces(q)
    assert _rel2(phi.numpy(), jphi) <= 1e-5
    assert _rel2(F.numpy(), jF) <= 1e-5


def test_forces_against_oracle(x64):
    """The forces converge to the f64 direct sum (degree 6)."""
    x, q = _particles(2, 1200)
    plan = TreecodeSolver(TreecodeConfig(theta=0.6, degree=6, leaf_size=64),
                          device="cpu").plan(x)
    _, F = plan.potential_and_forces(q)
    _, ref = direct_oracle_f64(x, q, kernel=plan.kernel)
    assert _rel2(F.numpy(), ref) < 1e-4


@pytest.mark.parametrize("space", ["free", "periodic"])
def test_forces_match_finite_differences(x64, space):
    """Moving target i only (sources fixed, the force convention); under
    PBC the forces follow the minimum-image fold."""
    x, q = _particles(8, 500)
    box = PeriodicBox((L, L, L)) if space == "periodic" else None
    solver = TreecodeSolver(TreecodeConfig(theta=0.7, degree=5, leaf_size=64,
                                           space=box), device="cpu")
    plan = solver.plan(x)
    phi, F = plan.potential_and_forces(q)
    np.testing.assert_allclose(phi.numpy(), plan.execute(q).numpy(),
                               rtol=1e-12)
    h = 1e-6
    rng = np.random.default_rng(9)
    for i in rng.integers(0, len(x), 2):
        for d in range(3):
            xp, xm = x.copy(), x.copy()
            xp[i, d] += h
            xm[i, d] -= h
            fp = solver.plan(xp, x).execute(q)[i].item()
            fm = solver.plan(xm, x).execute(q)[i].item()
            fd = -q[i] * (fp - fm) / (2 * h)
            rel = abs(F[i, d].item() - fd) / max(abs(fd), 1e-12)
            assert rel < 1e-3, (i, d, F[i, d].item(), fd)


@pytest.mark.parametrize("space", ["free", "periodic"])
def test_forces_antisymmetric_two_body(x64, space):
    """Two equal charges: F_0 == -F_1 along the separation axis; across a
    periodic boundary the nearer image wins."""
    pts = np.array([[0.3, 1.0, 1.0], [1.9, 1.0, 1.0]])
    q = np.array([1.0, 1.0])
    box = PeriodicBox((L, L, L)) if space == "periodic" else None
    plan = TreecodeSolver(TreecodeConfig(degree=2, leaf_size=4, space=box),
                          device="cpu").plan(pts)
    _, F = plan.potential_and_forces(q)
    F = F.numpy()
    np.testing.assert_allclose(F[0], -F[1], atol=1e-12)
    # free: 0 is pushed left (-x); periodic: the image at 1.9 - 2 = -0.1
    # is nearer, so 0 is pushed right
    assert (F[0, 0] < 0.0) == (space == "free")
    np.testing.assert_allclose(abs(F[0, 0]), 1 / (1.6 if space == "free"
                                                  else 0.4) ** 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("space", [FREE, PeriodicBox((1.0, 1.5, 2.0))])
def test_exact_hits_give_zero_gradient(dtype, space):
    """A particle meeting itself (r^2 == 0, targets == sources in MD)
    adds exactly 0 to phi and to every gradient component."""
    x = torch.tensor([[[0.2, -0.3, 0.4]]], dtype=dtype)
    soft = Kernel("soft", lambda r2, p: 1.0 / torch.sqrt(r2 + 0.1))
    for kern in (coulomb(), yukawa(0.5), soft):
        f = ops.batch_cluster_field(
            torch.zeros((1, 1), dtype=torch.int32), x, x.clone(),
            torch.ones((1, 1), dtype=dtype), kernel=kern, space=space)
        g = f[..., 1:]
        assert torch.isfinite(f).all() and (g == 0).all(), kern.name
        if kern is not soft:
            assert (f == 0).all(), kern.name


@pytest.mark.parametrize("space", [FREE, PeriodicBox((1.5, 2.0, 1.7))])
@pytest.mark.parametrize("r2_mode", ["diff", "matmul"])
@pytest.mark.parametrize("kahan", [False, True])
def test_field_plain_matches_torch_func(space, r2_mode, kahan):
    """The plain field against three forward JVPs of the plain potential
    (the reference's construction), with counts, sentinels and an exact
    hit; rtol 1e-10 with an atol of 1e-12 times max|value| (f64)."""
    rng = np.random.default_rng(3)
    B, S, NB, C, m = 3, 5, 17, 6, 11
    tgt = torch.as_tensor(rng.uniform(-1, 1, (B, NB, 3)))
    src = torch.as_tensor(rng.uniform(-1, 1, (C, m, 3)))
    q = torch.as_tensor(rng.uniform(-1, 1, (C, m)))
    idx = torch.as_tensor(rng.integers(-1, C, (B, S)), dtype=torch.int32)
    idx[:, 2] = -1
    idx[-1, 0] = 0
    tgt[-1, 0] = src[0, 0]                       # exact hit
    counts = dict(tgt_count=torch.tensor([NB, 9, 4], dtype=torch.int32),
                  src_count=torch.as_tensor(rng.integers(0, m + 1, C),
                                            dtype=torch.int32))
    soft = Kernel("soft", lambda r2, p: 1.0 / torch.sqrt(r2 + 0.1))
    for kern in (coulomb(), yukawa(0.7), soft):
        kw = dict(kernel=kern, space=space, kahan=kahan, r2_mode=r2_mode,
                  **counts)
        f = bcm.batch_cluster_field_plain(idx, tgt, src, q, **kw)

        def phi_of(t):
            return bcm.batch_cluster_eval_plain(idx, t, src, q, **kw)

        grads = []
        for d in range(3):
            tangent = torch.zeros_like(tgt)
            tangent[..., d] = 1.0
            phi, dphi = torch.func.jvp(phi_of, (tgt,), (tangent,))
            grads.append(dphi)
        want = torch.cat([phi[..., None], torch.stack(grads, -1)], -1)
        assert torch.isfinite(f).all()
        torch.testing.assert_close(f, want, rtol=1e-10,
                                   atol=1e-12 * want.abs().max().item())


def test_field_plain_magnitude_sums_term_magnitudes():
    """`magnitude=True` sums |G q| and |2 G' d_k q| over the same pairs
    (a pair-by-pair loop here, f64, rtol 1e-12); padded target slots,
    sentinels, counts and exact hits add 0, and it bounds |field|."""
    rng = np.random.default_rng(4)
    B, S, NB, C, m = 2, 3, 4, 3, 5
    tgt = rng.uniform(-1, 1, (B, NB, 3))
    src = rng.uniform(-1, 1, (C, m, 3))
    q = rng.uniform(-1, 1, (C, m))
    idx = np.array([[0, -1, 2], [1, 2, 0]], np.int32)
    tgt[1, 0] = src[0, 0]                        # exact hit
    tc, sc = np.array([4, 3]), np.array([5, 2, 4])
    kw = dict(kernel=yukawa(0.7), tgt_count=torch.as_tensor(tc),
              src_count=torch.as_tensor(sc))
    args = [torch.as_tensor(a) for a in (idx, tgt, src, q)]
    mag = bcm.batch_cluster_field_plain(*args, magnitude=True, **kw).numpy()
    want = np.zeros((B, NB, 4))
    for b, i, c in itertools.product(range(B), range(NB), range(C)):
        if i >= tc[b] or c not in idx[b]:
            continue
        for j in range(sc[c]):
            d = tgt[b, i] - src[c, j]
            r = np.sqrt(d @ d)
            if r == 0.0:
                continue
            g = np.exp(-0.7 * r) / r
            want[b, i] += abs(q[c, j]) * np.concatenate(
                [[g], (1 + 0.7 * r) * g / r ** 2 * np.abs(d)])
    np.testing.assert_allclose(mag, want, rtol=1e-12, atol=0)
    field = bcm.batch_cluster_field_plain(*args, **kw).numpy()
    assert (np.abs(field) <= mag * (1 + 1e-12)).all()


@pytest.mark.parametrize("kernel", [coulomb(), yukawa(0.7)],
                         ids=["coulomb", "yukawa"])
@pytest.mark.parametrize("space", [FREE, PeriodicBox((L, L, L))],
                         ids=["free", "periodic"])
def test_direct_field_matches_oracle(kernel, space):
    """The on-card forces reference (`direct_field`, torch, chunked)
    against the NumPy oracle, f64: rtol 1e-12 with an atol of 1e-12
    times max|value|, over targets == sources (exact hits add 0)."""
    x, q = _particles(12, 300)
    t = torch.as_tensor(x)
    phi, g = direct_field(t, t, torch.as_tensor(q), kernel=kernel,
                          space=space, source_chunk=70)
    rphi, rF = direct_oracle_f64(x, q, kernel=kernel, space=space)
    for got, want in ((phi.numpy(), rphi), (-q[:, None] * g.numpy(), rF)):
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_forces_disjoint_targets_need_weights():
    tgt, _ = _particles(10, 200, np.float32)
    src, q = _particles(11, 300, np.float32)
    plan = TreecodeSolver(TreecodeConfig(degree=3, leaf_size=32),
                          device="cpu").plan(tgt, src)
    with pytest.raises(ValueError, match="weights"):
        plan.potential_and_forces(q)
    w = np.ones(200, np.float32)
    phi, F = plan.potential_and_forces(q, weights=w)
    assert phi.shape == (200,) and F.shape == (200, 3)
    jplan = JSolver(JConfig(degree=3, leaf_size=32, backend="xla")).plan(
        tgt, src, nranks=1)
    _, jF = jplan.potential_and_forces(q, weights=w)
    assert _rel2(F.numpy(), jF) <= 1e-5

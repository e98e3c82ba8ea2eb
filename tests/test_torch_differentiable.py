"""The differentiable executor: the port's backward against `repro`'s VJP.

`repro_torch.core.eval.differentiable_execute` (a `torch.autograd.Function`
whose backward sweeps the transposed lists with the batch-cluster kernel's
plain version and transposes the modified charges on the CPU) against
`jax.vjp` of `repro.core.eval.differentiable_execute` with
``backend="xla"``, on the same plan arrays (the planners are bitwise
equal) and the same seeded charges and cotangent u.

Tolerances: f64 rtol 1e-10 with an absolute floor of 1e-12 times the
largest |value| (a cotangent sums signed terms and can cancel towards 0,
where only the absolute rounding of its large terms is left; the floor of
`test_torch_forces.py`); f32 relative 2-norm <= 1e-5. The target
cotangent is compared on the real target slots (`tgt_mask`) only: the
reference writes padded point-budget entries into the scratch slot with
`.at[].set`, where its value is unspecified. The adjoint identity
<u, A q> = <A^T u, q> holds in f64 to 1e-13 of |u| |A q|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as jev
from repro.core import potentials as jpot
from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.core.space import PeriodicBox as JBox
from repro_torch.core import eval as ev
from repro_torch.core import potentials as tpot
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.space import PeriodicBox
from repro_torch.kernels import batch_cluster as bcm
from repro_torch.kernels import modified_charges as mcm

L = 2.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _particles(seed, n, dtype=np.float64):
    r = np.random.default_rng(seed)
    return (r.uniform(0, L, (n, 3)).astype(dtype),
            r.uniform(-1, 1, n).astype(dtype),
            r.uniform(-1, 1, n).astype(dtype))


def _close_f64(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    floor = 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=floor,
                               err_msg=what)


def _rel2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np(v):
    if isinstance(v, tuple):
        return tuple(np.asarray(x) for x in v)
    return np.asarray(v)


def port_vjp(arrays, q, u, params, opts, targets=True, charges=True):
    """(phi, tbar or None, qbar or None) of the port's executor."""
    a = dict(arrays)
    tgt = a["tgt_batched"].clone().requires_grad_(targets)
    a["tgt_batched"] = tgt
    qt = torch.as_tensor(q).clone().requires_grad_(charges)
    phi = ev.differentiable_execute(a, qt, params, **opts)
    wrt = [t for t, on in ((tgt, targets), (qt, charges)) if on]
    grads = list(torch.autograd.grad(phi, wrt, torch.as_tensor(u)))
    tbar = grads.pop(0).numpy() if targets else None
    qbar = grads.pop(0).numpy() if charges else None
    return phi.detach().numpy(), tbar, qbar


def ref_vjp(jarrays, q, u, params, opts):
    """(phi, tbar, qbar) of `jax.vjp` through the reference's executor."""
    jarrays = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
                   else jnp.asarray(v)) for k, v in jarrays.items()}

    def f(t, c):
        return jev.differentiable_execute(dict(jarrays, tgt_batched=t), c,
                                          params, **opts)

    phi, vjp = jax.vjp(f, jarrays["tgt_batched"], jnp.asarray(q))
    tbar, qbar = vjp(jnp.asarray(u))
    return np.asarray(phi), np.asarray(tbar), np.asarray(qbar)


def check_f64(got, want, mask):
    """phi, the target cotangent on the real slots and the charge
    cotangent, each at the f64 bar."""
    _close_f64(got[0], want[0], "phi")
    _close_f64(got[1][mask], want[1][mask], "target cotangent")
    _close_f64(got[2], want[2], "charge cotangent")


# (theta, degree, leaf_size): the periodic box needs small clusters for
# fold-free approximations to exist at these N (`test_torch_forces.py`)
SETTINGS = {"free": (0.7, 3, 32), "periodic": (0.8, 2, 16)}


def solvers(space, kernel, skin, kahan=False, approx_r2="diff",
            precompute="direct", **extra):
    """(port solver on the CPU, reference solver on XLA), one config."""
    theta, degree, leaf = SETTINGS[space]
    opts = dict(theta=theta, degree=degree, leaf_size=leaf, kernel=kernel,
                skin=skin, kahan=kahan, approx_r2=approx_r2,
                precompute=precompute, **extra)
    if kernel == "yukawa":
        opts["kernel_params"] = {"kappa": 0.8}
    periodic = space == "periodic"
    port = TreecodeSolver(TreecodeConfig(
        space=PeriodicBox((L, L, L)) if periodic else None, **opts),
        device="cpu")
    ref = JSolver(JConfig(space=JBox((L, L, L)) if periodic else None,
                          backend="xla", **opts))
    return port, ref


def both(port_plan, ref_plan, q, u):
    """(port's (phi, tbar, qbar), reference's) on a solver plan pair."""
    got = port_vjp(port_plan.arrays, q, u, port_plan.kernel_params,
                   port_plan.config.exec_opts(port_plan.kernel))
    want = ref_vjp(_np_arrays(ref_plan.inner.arrays), q, u,
                   ref_plan.kernel_params,
                   ref_plan.config.exec_opts(ref_plan.kernel))
    return got, want


def _np_arrays(arrays):
    return {k: _np(v) for k, v in arrays.items()}


# (space, kernel, skin, kahan, approx_r2, precompute)
F64_CASES = [
    ("free", "coulomb", 0.0, False, "diff", "direct"),
    ("free", "yukawa", 0.03, True, "diff", "direct"),
    ("free", "coulomb", 0.0, False, "matmul", "direct"),
    ("free", "coulomb", 0.03, False, "diff", "hierarchical"),
    ("periodic", "coulomb", 0.03, False, "diff", "direct"),
    ("periodic", "yukawa", 0.0, False, "diff", "hierarchical"),
]


@pytest.mark.parametrize("space,kernel,skin,kahan,approx_r2,precompute",
                         F64_CASES)
def test_cotangents_match_reference_f64(x64, space, kernel, skin, kahan,
                                        approx_r2, precompute):
    x, q, u = _particles(0, 1000)
    port, ref = solvers(space, kernel, skin, kahan, approx_r2, precompute)
    plan = port.plan(x)
    a = plan.arrays
    assert (a["approx_idx"] >= 0).any()
    if skin > 0:
        assert (a["approx_skin"] != 0).any()      # the routing is exercised
    got, want = both(plan, ref.plan(x, nranks=1), q, u)
    check_f64(got, want, a["tgt_mask"].numpy())
    # phi is execute's, bitwise
    np.testing.assert_array_equal(got[0], plan.execute(q).numpy())


@pytest.mark.parametrize("space,kernel,approx_r2",
                         [("free", "coulomb", "matmul"),
                          ("periodic", "yukawa", "diff")])
def test_cotangents_match_reference_f32(space, kernel, approx_r2):
    x, q, u = _particles(1, 600, np.float32)
    port, ref = solvers(space, kernel, 0.02, approx_r2=approx_r2)
    plan = port.plan(x)
    got, want = both(plan, ref.plan(x, nranks=1), q, u)
    assert got[2].dtype == np.float32
    mask = plan.arrays["tgt_mask"].numpy()
    assert _rel2(got[0], want[0]) <= 1e-5
    assert _rel2(got[1][mask], want[1][mask]) <= 1e-5
    assert _rel2(got[2], want[2]) <= 1e-5


def test_targets_differ_from_sources_f64(x64):
    x, q, _ = _particles(2, 900)
    t = np.random.default_rng(3).uniform(0, L, (700, 3))
    u = np.random.default_rng(4).uniform(-1, 1, 700)
    port, ref = solvers("free", "yukawa", 0.02)
    plan = port.plan(t, x)
    got, want = both(plan, ref.plan(t, x, nranks=1), q, u)
    assert got[0].shape == (700,) and got[2].shape == (900,)
    check_f64(got, want, plan.arrays["tgt_mask"].numpy())


def test_capacity_padded_plan_f64(x64):
    x, q, u = _particles(5, 900)
    port, ref = solvers("free", "coulomb", 0.03)
    plan = port.plan(x, capacities="auto")
    assert plan.capacities is not None
    got, want = both(plan, ref.plan(x, nranks=1, capacities="auto"), q, u)
    check_f64(got, want, plan.arrays["tgt_mask"].numpy())
    # the padding changes nothing: the unpadded plan's cotangents
    flat = port.plan(x)
    _, tb, qb = port_vjp(flat.arrays, q, u, flat.kernel_params,
                         flat.config.exec_opts(flat.kernel))
    _close_f64(got[2], qb, "padded vs unpadded charge cotangent")
    _close_f64(got[1][plan.arrays["tgt_mask"].numpy()],
               tb[flat.arrays["tgt_mask"].numpy()],
               "padded vs unpadded target cotangent")


def test_point_budgeted_plan_f64(x64):
    """Point budgets pad both particle axes: padded charges get a zero
    cotangent, and padded entries of u reach no real slot."""
    r = np.random.default_rng(6)
    x = r.uniform(-1, 1, (260, 3))
    kw = dict(theta=0.7, degree=3, leaf_size=16, batch_size=16, skin=0.02)
    opts = dict(degree=3, theta=0.7, skin=0.02)
    jplan = jev.prepare_plan(x, x, **kw)
    need = dict(jev._plan_dims(jplan), num_targets=300, num_sources=300)
    jcaps = jev.Capacities.for_need(need, headroom=1.0, base=1)
    jarrays = _np_arrays(jev.pad_plan(jplan, jcaps).arrays)
    plan = ev.prepare_plan(x, x, device="cpu", **kw)
    caps = ev.Capacities.for_need(
        dict(ev._plan_dims(plan), num_targets=300, num_sources=300),
        headroom=1.0, base=1)
    a = ev.pad_plan(plan, caps).arrays
    q = r.uniform(-1, 1, 300)
    q[260:] = 0.0
    u = r.uniform(-1, 1, 300)                    # padded u too
    got = port_vjp(a, q, u, None, dict(opts, kernel=tpot.coulomb()))
    want = ref_vjp(jarrays, q, u, None, dict(opts, kernel=jpot.coulomb()))
    check_f64(got, want, a["tgt_mask"].numpy())
    assert (got[2][260:] == 0).all() and (got[0][260:] == 0).all()
    scratch = a["tgt_mask"].shape[1] * caps.scratch_batch
    assert (got[1].reshape(-1, 3)[scratch] == 0).all()


def test_device_built_plan_f64(x64):
    x, q, u = _particles(7, 1000)
    port, ref = solvers("free", "coulomb", 0.02, build_backend="device",
                        dtype="float64")
    plan = port.plan(x)
    assert plan.stats()["build_backend"] == "device"
    got, want = both(plan, ref.plan(x, nranks=1), q, u)
    check_f64(got, want, plan.arrays["tgt_mask"].numpy())


@pytest.mark.parametrize("precompute", ["direct", "hierarchical"])
def test_adjoint_identity_f64(precompute):
    """<u, A q> = <A^T u, q> for the treecode operator A itself."""
    x, q, u = _particles(8, 1500)
    port, _ = solvers("free", "yukawa", 0.03, precompute=precompute,
                      dtype="float64")
    plan = port.plan(x)
    phi, _, qbar = port_vjp(plan.arrays, q, u, plan.kernel_params,
                            plan.config.exec_opts(plan.kernel),
                            targets=False)
    lhs, rhs = float(u @ phi), float(qbar @ q)
    assert abs(lhs - rhs) <= 1e-13 * np.linalg.norm(u) * np.linalg.norm(phi)


@pytest.mark.parametrize("wrt", ["charges", "targets"])
def test_gradcheck_tiny_plan(wrt):
    r = np.random.default_rng(9)

    def blobs():    # two distant blobs: the tiny plan approximates
        return np.concatenate([r.uniform(-1, -0.7, (30, 3)),
                               r.uniform(0.7, 1, (30, 3))])

    # targets apart from the sources: a target moved off a source it sits
    # on would meet the singularity that an exact hit skips
    x, t = blobs(), blobs()
    q = torch.as_tensor(r.uniform(-1, 1, 60))
    plan = TreecodeSolver(TreecodeConfig(theta=0.7, degree=2, leaf_size=8,
                                         batch_size=8, dtype="float64"),
                          device="cpu").plan(t, x)
    a = plan.arrays
    assert (a["approx_idx"] >= 0).any()
    opts = plan.config.exec_opts(plan.kernel)
    if wrt == "charges":
        def fn(c):
            return ev.differentiable_execute(a, c, None, **opts)
        arg = q.clone().requires_grad_()
    else:
        def fn(t):
            return ev.differentiable_execute(dict(a, tgt_batched=t), q,
                                             None, **opts)
        arg = a["tgt_batched"].clone().requires_grad_()
    assert torch.autograd.gradcheck(fn, (arg,), eps=1e-6, atol=1e-7,
                                    rtol=1e-5)


def _counting(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("wrt", ["charges", "targets"])
def test_backward_runs_only_what_is_asked(monkeypatch, wrt):
    """A charges-only backward runs no field sweep; a targets-only one
    runs no transposed pass (the plain versions count their calls)."""
    x, q, u = _particles(10, 500)
    plan = TreecodeSolver(TreecodeConfig(theta=0.7, degree=3, leaf_size=32),
                          device="cpu").plan(x)
    a = dict(plan.arrays)
    tgt = a["tgt_batched"].clone().requires_grad_(wrt == "targets")
    a["tgt_batched"] = tgt
    qt = torch.as_tensor(q).requires_grad_(wrt == "charges")
    phi = ev.differentiable_execute(a, qt, None,
                                    **plan.config.exec_opts(plan.kernel))
    counts = {}
    for name in ("batch_cluster_eval_plain", "batch_cluster_field_plain",
                 "batch_cluster_field_grid_plain"):
        _counting(monkeypatch, bcm, name, counts)
    _counting(monkeypatch, mcm, "modified_charges_transpose_ranged_plain",
              counts)
    _counting(monkeypatch, mcm, "modified_charges_ranged_plain", counts)
    (grad,) = torch.autograd.grad(phi, (tgt if wrt == "targets" else qt,),
                                  torch.as_tensor(u))
    assert torch.isfinite(grad).all()
    if wrt == "charges":
        assert counts == {"batch_cluster_eval_plain": 2,
                          "modified_charges_transpose_ranged_plain": 1}
    else:
        assert counts == {"batch_cluster_field_plain": 1,
                          "batch_cluster_field_grid_plain": 1,
                          "modified_charges_ranged_plain": 1}


def test_stacked_arrays_raise():
    x, q, _ = _particles(11, 200)
    plan = TreecodeSolver(TreecodeConfig(theta=0.7, degree=2, leaf_size=32),
                          device="cpu").plan(x)
    stack = {k: (tuple(t[None] for t in v) if isinstance(v, tuple)
                 else v[None]) for k, v in plan.arrays.items()}
    with pytest.raises(ValueError, match="stacked"):
        ev.differentiable_execute(stack, torch.as_tensor(q)[None], None,
                                  **plan.config.exec_opts(plan.kernel))

"""The port's runtime checks (`repro_torch.lint.runtime`), the twins of
`tests/test_transfer_guard.py`, on the CPU's half of the guard.

`no_implicit_syncs("cpu")` raises on the ops that would sync the host
with the device on CUDA (scalar reads, host pulls, data-dependent
shapes); `explicit_sync(reason)` is the sanctioned pull and is counted.
So "passes under the guard" proves the steady loops make no implicit
sync, and the counts prove the one explicit pull per refit step: the
drift. On the CPU the plain modified charges add their own width read
("plain_width"), which the card's kernels do not make; chip_smoke.py
phase 15b holds the card's count to exactly {"drift": 1}.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import eval as ceval
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.dynamics import Simulation
from repro_torch.lint import runtime as rt
from repro_torch.serve import ServeFrontend

#: The only pull besides the engine's that a CPU refit step makes.
PLAIN = "plain_width"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def nans_off(monkeypatch):
    """REPRO_DEBUG_NANS unset and the runtime's mode restored after."""
    monkeypatch.delenv("REPRO_DEBUG_NANS", raising=False)
    prev = rt.set_debug_nans(False)
    yield monkeypatch
    rt.set_debug_nans(prev)


def _cloud(n, seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(-1, 1, (n, 3)).astype(np.float32),
            (0.05 * r.uniform(-1, 1, n)).astype(np.float32))


def _plan(x, build_backend="host", nranks=None, **kw):
    cfg = TreecodeConfig(theta=0.7, degree=2, leaf_size=32,
                         build_backend=build_backend, **kw)
    solver = TreecodeSolver(cfg, device="cpu")
    if nranks is not None:
        return solver.plan(x, nranks=nranks)
    return solver.plan(x, capacities="auto")


def _guarded_steps(sim, steps):
    """`steps` steps under the guard; per refit step the explicit pulls
    by reason (the CPU's plain-version reads left out)."""
    per_refit = []
    with rt.no_implicit_syncs("cpu"):
        for _ in range(steps):
            before, refits = rt.sync_counts(), sim.refits
            sim.step()
            after = rt.sync_counts()
            delta = {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}
            if sim.refits > refits:
                per_refit.append({k: v for k, v in delta.items()
                                  if k != PLAIN})
    return per_refit


@pytest.mark.parametrize("kind", ["host", "device", "async", "sharded"])
def test_md_steps_under_sync_guard(kind, nans_off):
    """Host-plan, device-plan, async-replan and sharded (2 ranks) MD
    steps through a rebuild with implicit syncs disallowed: every refit
    step pulls exactly once, the drift."""
    x, q = _cloud(400 if kind != "sharded" else 300)
    plan = _plan(x, "host" if kind in ("host", "sharded") else "device",
                 nranks=2 if kind == "sharded" else None)
    sim = Simulation(plan, q, dt=1e-5, refit_interval=4,
                     async_replan=kind == "async")
    for _ in range(2):                  # warm: first rebuild path too
        sim.step()
    per_refit = _guarded_steps(sim, 5)  # crosses refit_interval=4
    s = sim.stats()
    assert s["steps"] == 7 and s["rebuilds"] >= 1, s
    assert per_refit and all(d == {"drift": 1} for d in per_refit), \
        per_refit
    if kind == "device":
        assert s["devtree_rebuilds"] == s["rebuilds"]
    if kind == "async":
        assert s["plan_swaps"] >= 1
    assert torch.isfinite(sim.state.f).all()


def test_serve_warm_flush_under_sync_guard(nans_off):
    """Warm-bucket flushes: the only pulls are the host plan build, the
    request payloads going up and the results coming back."""
    r = np.random.default_rng(3)
    cfg = TreecodeConfig(degree=3, leaf_size=16, theta=0.7)
    fe = ServeFrontend(cfg, max_batch=2, device="cpu")
    xs = [r.uniform(-1, 1, (24, 3)).astype(np.float32) for _ in range(2)]
    qs = [r.uniform(-1, 1, 24).astype(np.float32) for _ in range(2)]
    cold = [fe.submit(x, q) for x, q in zip(xs, qs)]
    before = rt.sync_counts()
    with rt.no_implicit_syncs("cpu"):
        futs = [fe.submit(x, q) for x, q in zip(xs, qs)]
        assert all(f.done() for f in futs)
    after = rt.sync_counts()
    delta = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    assert set(delta) <= {"serve_plan_build", "host_build", "upload",
                          "serve_result", PLAIN}, delta
    assert delta["serve_result"] == 1 and delta["serve_plan_build"] == 1
    s = fe.stats()
    assert s["flushes"] == 2 and s["retraces"] == 0
    for f, c in zip(futs, cold):
        assert torch.equal(f.result(), c.result())


@pytest.mark.parametrize("form", ["item", "mask", "float", "if", "tolist",
                                  "cpu", "nonzero"])
def test_guard_raises_on_implicit_sync(form):
    """Positive control: each form the lint names raises in the guard;
    the same read inside explicit_sync passes and is counted."""
    t = torch.arange(6.0)
    m = t > 2
    forms = {"item": lambda: t.sum().item(), "mask": lambda: t[m],
             "float": lambda: float(t.sum()),
             "if": lambda: 1 if t.sum() > 0 else 0,
             "tolist": lambda: t.tolist(), "cpu": lambda: t.cpu(),
             "nonzero": lambda: t.nonzero()}
    with rt.no_implicit_syncs("cpu"):
        with pytest.raises(rt.ImplicitSyncError):
            forms[form]()
        n = rt.sync_counts().get("probe", 0)
        with rt.explicit_sync("probe"):
            forms[form]()
        assert rt.sync_counts()["probe"] == n + 1
        torch.where(m, t, 0.0)            # fixed shapes stay legal
        t[m] = 0.0                        # a masked fill: no sync


def test_guard_restores_after_a_raise():
    """A raise inside the guard leaves no mode behind."""
    t = torch.ones(3)
    with pytest.raises(rt.ImplicitSyncError):
        with rt.no_implicit_syncs("cpu"):
            t.sum().item()
    assert t.sum().item() == 3.0


def test_debug_nans_opt_in(nans_off):
    """REPRO_DEBUG_NANS=1 turns the mode on through the constructors;
    unset, it stays off; clean steps give no false positive."""
    monkeypatch = nans_off
    cfg = TreecodeConfig(degree=2, leaf_size=16)
    assert ServeFrontend(cfg, max_batch=1, device="cpu").debug_nans is False
    x, q = _cloud(200)
    sim = Simulation(_plan(x), q, dt=1e-5, refit_interval=4)
    assert sim.debug_nans is False and rt.DEBUG_NANS is False

    monkeypatch.setenv("REPRO_DEBUG_NANS", "1")
    assert ServeFrontend(cfg, max_batch=1, device="cpu").debug_nans is True
    assert rt.DEBUG_NANS is True
    sim = Simulation(_plan(x, "device"), q, dt=1e-5, refit_interval=4)
    assert sim.debug_nans is True
    before = rt.sync_counts().get("debug_nans", 0)
    sim.run(5)                      # clean dynamics through a rebuild
    assert rt.sync_counts()["debug_nans"] > before
    assert torch.isfinite(sim.state.f).all()


def _nan_input():
    x, q = _cloud(300, seed=7)
    q = q.copy()
    q[123] = np.nan
    return x, q


def test_debug_nans_catches_injected_nan_reference(monkeypatch):
    """The reference's form: with the mode on, its execute of a NaN
    charge raises FloatingPointError at the producing op."""
    import jax
    from repro.core.api import TreecodeConfig as JConfig
    from repro.core.api import TreecodeSolver as JSolver
    from repro.serve import ServeFrontend as JFrontend

    prev = jax.config.jax_debug_nans
    monkeypatch.setenv("REPRO_DEBUG_NANS", "1")
    x, q = _nan_input()
    try:
        JFrontend(JConfig(degree=2, leaf_size=16, backend="xla"),
                  max_batch=1)              # flips the jax flag
        plan = JSolver(JConfig(theta=0.7, degree=2, leaf_size=32,
                               backend="xla")).plan(x)
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(plan.execute(q))
    finally:
        jax.config.update("jax_debug_nans", prev)


def test_debug_nans_catches_injected_nan(nans_off):
    """The same input in the port: the first kernel entry that sees the
    NaN (the modified charges) raises, naming itself; a NaN that reaches
    a lane first is named with its lane; with the mode off it flows
    through."""
    monkeypatch = nans_off
    x, q = _nan_input()
    plan = _plan(x)
    assert torch.isnan(plan.execute(q)).any()       # mode off
    monkeypatch.setenv("REPRO_DEBUG_NANS", "1")
    ServeFrontend(TreecodeConfig(degree=2, leaf_size=16), max_batch=1,
                  device="cpu")                     # turns the mode on
    with pytest.raises(FloatingPointError, match="modified_charges_ranged"):
        plan.execute(q)
    # a NaN that reaches a lane first is named with its lane: q_hat from
    # the finite charges, the leaves' charges with the NaN
    orig = ceval._QHAT["direct"]
    monkeypatch.setitem(ceval._QHAT, "direct", lambda a, qs, **kw: orig(
        a, torch.nan_to_num(qs), **kw))
    with pytest.raises(FloatingPointError,
                       match=r"batch_cluster_eval.*direct lane"):
        plan.execute(q)
    monkeypatch.setitem(ceval._QHAT, "direct", orig)
    # the differentiable executor's backward checks its cotangents
    qd = torch.tensor(_cloud(300, 7)[1], requires_grad=True)
    phi = ceval.differentiable_execute(plan.arrays, qd,
                                       **plan.config.exec_opts(plan.kernel))
    u = torch.ones_like(phi)
    u[5] = float("nan")
    with pytest.raises(FloatingPointError):
        torch.autograd.grad(phi, qd, u)


@pytest.mark.cuda
def test_cuda_guard_around_warm_execute(nans_off):
    """On the card: a warm execute under set_sync_debug_mode("error")
    makes no sync, and the previous mode comes back after a raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, q = _cloud(4000)
    plan = TreecodeSolver(TreecodeConfig(theta=0.7, degree=4,
                                         leaf_size=128)).plan(x)
    qd = torch.as_tensor(q, device="cuda")
    plan.execute(qd)
    torch.cuda.synchronize()
    with rt.no_implicit_syncs():
        phi = plan.execute(qd)
        with rt.explicit_sync("test"):
            assert torch.isfinite(phi).all().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    with pytest.raises(rt.ImplicitSyncError):
        with rt.no_implicit_syncs():
            phi.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_cuda_debug_nans_on_kernel_output(nans_off):
    """On the card: the NaN check of a CUDA kernel's output names it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, q = _nan_input()
    plan = TreecodeSolver(TreecodeConfig(theta=0.7, degree=2,
                                         leaf_size=32)).plan(x)
    rt.set_debug_nans(True)
    with pytest.raises(FloatingPointError, match="modified_charges_ranged"):
        plan.execute(torch.as_tensor(q, device="cuda"))

"""Double-buffered async replan on the port (`Simulation(async_replan=True)`,
`SingleDevicePlan.replan_async`): twins of `tests/test_async_replan.py`.

A shadow device build dispatched while the engine keeps refitting on the
live plan must be invisible to the live plan until the swap:

- only a capacity-padded device-built plan under rebuild="auto" may run
  it;
- steady state: swaps land at step boundaries, count as rebuilds under
  their dispatch-time cause, both partitions of the rebuild count stay
  exact, and a swap that fits the budget makes no new shape;
- a budget overflow inside an in-flight shadow (the commit reruns the
  growth loop) leaves the live plan's arrays and results untouched, and
  the engine counts it like a synchronous growth;
- the engine's dispatch triggers (drift at `dispatch_fraction` of a
  budget, the interval one step early), the swap at the next step
  boundary and the re-anchoring on wrapped positions: an f64 run held
  against `repro.dynamics.Simulation(async_replan=True)` at rtol 1e-9,
  with the same counters.

On the CPU the shadow build runs at once, with no stream; on the card it
runs on a side stream (`chip_smoke.py` dispatches it under
``torch.cuda.set_sync_debug_mode("error")``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.core.space import FREE as JFREE
from repro.core.space import PeriodicBox as JBox
from repro.dynamics import Simulation as JSimulation
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.space import FREE, PeriodicBox
from repro_torch.dynamics import Simulation
from repro_torch.obs import events, trace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(-1, 1, (n, 3)).astype(np.float32),
            (0.05 * r.uniform(-1, 1, n)).astype(np.float32))


def _plan(x, build_backend="device", **kw):
    cfg = TreecodeConfig(theta=0.7, degree=2, leaf_size=32,
                         build_backend=build_backend, **kw)
    return TreecodeSolver(cfg, device="cpu").plan(x, capacities="auto")


def _sim(plan, q, **kw):
    kw.setdefault("dt", 1e-5)
    kw.setdefault("refit_interval", 4)
    kw.setdefault("async_replan", True)
    return Simulation(plan, q, **kw)


def _assert_partitions(s):
    assert s["rebuilds"] == (s["rebuilds_drift"] + s["rebuilds_interval"]
                             + s["rebuilds_forced"]), s
    assert s["rebuilds"] == s["rebuilds_host"] + s["devtree_rebuilds"], s


def test_async_replan_rejects_non_device_and_non_auto():
    x, q = _cloud(400)
    host_plan = _plan(x, build_backend="host")
    with pytest.raises(ValueError, match="device"):
        Simulation(host_plan, q, dt=1e-5, async_replan=True)
    with pytest.raises(ValueError, match="device"):
        host_plan.replan_async(x)
    dev_plan = _plan(x)
    with pytest.raises(ValueError, match="auto"):
        _sim(dev_plan, q, rebuild="always")
    with pytest.raises(ValueError, match="dispatch_fraction"):
        _sim(dev_plan, q, dispatch_fraction=0.0)


def test_steady_state_swaps_make_no_new_shapes():
    x, q = _cloud(900, 1)
    plan = _plan(x)
    trace.clear()
    trace.enable()
    try:
        sim = _sim(plan, q)
        sim.run(12)
        spans = [r["name"] for r in trace.spans()]
    finally:
        trace.disable()
        trace.clear()
    s = sim.stats()
    # the interval soft trigger dispatched shadows, each swapped in at a
    # step boundary and counted as an interval rebuild
    assert s["plan_swaps"] >= 2, s
    assert s["rebuilds"] == s["plan_swaps"] == s["rebuilds_interval"], s
    assert s["devtree_rebuilds"] == s["rebuilds"], s
    _assert_partitions(s)
    assert s["retraces"] == 0 and s["capacity_growths"] == 0, s
    assert 0.0 <= s["rebuild_wait_ms"] <= s["rebuild_total_ms"], s
    assert spans.count("plan_swap") == s["plan_swaps"]
    assert "md.rebuild_dispatch" in spans
    assert s["async_replan"] and "pending_replan" in s


def test_shadow_growth_does_not_perturb_live_plan():
    x, q = _cloud(1200, 2)
    plan = _plan(x)
    ref = plan.execute(q).clone()
    snap = {k: v.clone() for k, v in plan.inner.arrays.items()
            if not isinstance(v, tuple)}
    # undersize the live budget so the dispatch overflows: the shadow's
    # growth loop runs entirely inside finalize()
    caps = plan.inner.capacities
    plan.inner.capacities = dataclasses.replace(
        caps, approx_width=8, direct_width=16)
    growths = events.log.count(owner="devtree", kind="capacity_growth")
    pending = plan.replan_async(x)
    for k, v in snap.items():
        assert torch.equal(plan.inner.arrays[k], v), k
    p2, wait_ms, grew = pending.finalize()
    assert grew and wait_ms >= 0.0
    assert events.log.count(owner="devtree",
                            kind="capacity_growth") > growths
    for k, v in snap.items():
        assert torch.equal(plan.inner.arrays[k], v), k
    assert torch.equal(plan.execute(q), ref)
    # the grown shadow is a valid plan over the same positions
    assert p2.capacities.approx_width >= caps.approx_width
    torch.testing.assert_close(p2.execute(q), ref, rtol=2e-5, atol=2e-5)
    with pytest.raises(RuntimeError):
        pending.finalize()


def test_engine_growth_during_shadow_keeps_partitions_exact():
    x, q = _cloud(900, 3)
    sim = _sim(_plan(x), q, refit_interval=3)
    while sim.stats()["plan_swaps"] == 0:
        sim.step()
    assert sim._pending is None      # a swap step never re-dispatches
    sim.plan.inner.capacities = dataclasses.replace(
        sim.plan.inner.capacities, approx_width=8, direct_width=16)
    before = sim.stats()
    growth_events = events.log.count(owner="devtree", kind="capacity_growth")
    while sim._pending is None:
        sim.step()
    sim.step()                       # commits the overflowing shadow
    s = sim.stats()
    assert events.log.count(owner="devtree",
                            kind="capacity_growth") > growth_events
    assert s["plan_swaps"] == before["plan_swaps"] + 1, s
    assert s["rebuilds"] == before["rebuilds"] + 1, s
    _assert_partitions(s)
    assert s["devtree_rebuilds"] == s["rebuilds"], s
    # regrowing from the undersized budget at (near) unchanged positions
    # may land on the original shapes: then no growth is counted; either
    # way the retraces are the counted growths
    assert (s["capacity_growths"] - before["capacity_growths"]) in (0, 1), s
    assert s["retraces"] == s["capacity_growths"], s
    st = sim.step()
    assert torch.isfinite(st.f).all()
    _assert_partitions(sim.stats())


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


#: (points, box or None, refit interval, the cause the run must take):
#: in a periodic 2^3 box no pair passes the MAC at 600 points, so the
#: slacks are infinite and the interval trigger dispatches every shadow,
#: one step before the hard cadence, while particles cross the boundary
#: (the swap re-anchors them on wrapped positions); in free space at 900
#: points a per-step drift above half the theta budget dispatches them.
ASYNC_CASES = {
    "periodic_interval": (600, 2.0, 4, "rebuilds_interval"),
    "free_drift": (900, None, 8, "rebuilds_drift"),
}


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
def test_async_simulation_matches_reference_f64(x64, case):
    n, box, refit_interval, cause = ASYNC_CASES[case]
    r = np.random.default_rng(7)
    x = r.uniform(0.0, 2.0, (n, 3))
    q = 0.05 * r.uniform(-1, 1, n)
    v = 3.0 * np.random.default_rng(8).uniform(-1, 1, (n, 3))
    space, jspace = ((PeriodicBox((box,) * 3), JBox((box,) * 3)) if box
                     else (FREE, JFREE))
    kw = dict(theta=0.8, degree=3, leaf_size=32, build_backend="device",
              skin=0.03)
    sim_kw = dict(velocities=v, dt=2e-3, refit_interval=refit_interval,
                  async_replan=True, dispatch_fraction=0.5)
    sim = Simulation(TreecodeSolver(TreecodeConfig(space=space, **kw),
                                    device="cpu").plan(x, capacities="auto"),
                     q, **sim_kw)
    jsim = JSimulation(JSolver(JConfig(backend="xla", space=jspace, **kw))
                       .plan(x, nranks=1, capacities="auto"), q, **sim_kw)
    sim.run(10)
    jsim.run(10)
    jf = np.asarray(jsim.state.f)
    np.testing.assert_allclose(sim.state.x.numpy(), np.asarray(jsim.state.x),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sim.state.f.numpy(), jf, rtol=1e-9,
                               atol=1e-9 * np.abs(jf).max())
    s, j = sim.stats(), jsim.stats()
    for key in ("steps", "refits", "rebuilds", "rebuilds_drift",
                "rebuilds_interval", "rebuilds_forced", "rebuilds_host",
                "devtree_rebuilds", "plan_swaps", "retraces",
                "capacity_growths", "force_evals"):
        assert s[key] == j[key], (key, s[key], j[key])
    assert s["plan_swaps"] == s["rebuilds"] == s[cause] >= 2, s
    if box:
        assert ((x + 10 * 2e-3 * v < 0) | (x + 10 * 2e-3 * v >= box)).any()

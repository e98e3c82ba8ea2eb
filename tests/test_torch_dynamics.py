"""MD on the port: refit, slacks, integrators, the engine and checkpoints,
held against `repro.dynamics` on the same seeded inputs.

The reference runs on ``backend="xla"``, the port on ``device="cpu"``
(the kernels' plain versions). Tolerances: refitted boxes and slabs are
gathers and min/max, so they are equal exactly; slacks rtol 1e-12 (f64);
a 10-step f64 trajectory rtol 1e-9 on the positions, with the same
refit, rebuild and cause counts. Langevin noise comes from a
`torch.Generator`, which cannot give `jax.random`'s bits, so it is
checked statistically."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import Checkpointer as JCheckpointer
from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.core.space import PeriodicBox as JBox
from repro.dynamics import Simulation as JSimulation
from repro.dynamics import diagnostics as jdiag
from repro.dynamics import refit as jrefit
from repro.obs.occupancy import occupancy_counters as j_occupancy
from repro_torch.checkpoint.store import Checkpointer
from repro_torch.core import eval as ev
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.space import PeriodicBox
from repro_torch.dynamics import (Simulation, get_integrator, initial_state,
                                  make_adapter, refit_single_arrays,
                                  refresh_slacks_single,
                                  registered_integrators, summarize)
from repro_torch.obs.occupancy import occupancy_counters

KW = dict(theta=0.8, degree=3, leaf_size=32)
L = 2.0



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps OpenMP from spinning
    against the other test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed=1234, n=300, dtype=np.float32):
    r = np.random.default_rng(seed)
    return (r.uniform(-1, 1, (n, 3)).astype(dtype),
            (0.05 * r.uniform(-1, 1, n)).astype(dtype))


def _solver(**kw):
    return TreecodeSolver(TreecodeConfig(**dict(KW, **kw)), device="cpu")


def _jsolver(**kw):
    return JSolver(JConfig(backend="xla", **dict(KW, **kw)))


def _sim(x, q, **kw):
    opts = dict(dt=2e-4, refit_interval=8)
    opts.update(kw)
    return Simulation(_solver().plan(x), q, **opts)


# ---------------------------------------------------------------------------
# refit and slacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("space", ["free", "periodic"])
def test_refit_and_slacks_match_reference(x64, space):
    periodic = space == "periodic"
    x, _ = _cloud(n=1500 if periodic else 900, dtype=np.float64)
    x = x + 1.0                                   # inside [0, 2)^3
    # the periodic box needs small clusters for fold-free approximations
    kw = dict(theta=0.9, degree=2, leaf_size=16) if periodic \
        else dict(skin=0.03)
    plan = _solver(space=PeriodicBox((L,) * 3) if periodic else None,
                   **kw).plan(x, capacities="auto")
    jplan = _jsolver(space=JBox((L,) * 3) if periodic else None, **kw).plan(
        x, nranks=1, capacities="auto")
    x1 = x + np.random.default_rng(5).normal(0, 0.01, x.shape)
    got = refit_single_arrays(plan.arrays, torch.as_tensor(x1))
    want = jrefit.refit_single_arrays(jplan.inner.arrays, jnp.asarray(x1))
    for key in ("src_sorted", "node_lo", "node_hi", "tgt_batched"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert not torch.equal(got["node_lo"], plan.arrays["node_lo"])
    cfg = plan.config
    ts, fs = refresh_slacks_single(got, theta=cfg.theta, space=cfg.space)
    jts, jfs = jrefit.refresh_slacks_single(
        want, theta=cfg.theta, space=jplan.config.space)
    assert np.isfinite(ts.item())
    np.testing.assert_allclose([ts.item(), fs.item()],
                               [float(jts), float(jfs)], rtol=1e-12)


def test_scratch_row_stays_unit_box():
    """Every padded bucket row names the scratch node; the refit writes
    the old [0, 1] box there whatever order duplicates land in."""
    x, _ = _cloud()
    plan = _solver().plan(x, capacities="auto")
    caps, a = plan.capacities, plan.arrays
    n_real = plan.inner.tree.num_nodes
    assert any((nodes == caps.scratch_node).sum() > 1
               for nodes in a["bucket_nodes"])
    x1 = torch.as_tensor(x) * 1.3 + 0.2
    for _ in range(2):
        a = refit_single_arrays(a, x1)
        assert (a["node_lo"][n_real:] == 0).all()
        assert (a["node_hi"][n_real:] == 1).all()
    tree_lo = x1[plan.arrays["src_perm"]].amin(0)
    torch.testing.assert_close(a["node_lo"][0], tree_lo, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the engine against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("integrator,space", [("velocity_verlet", "free"),
                                              ("leapfrog", "periodic")])
def test_simulation_matches_reference_f64(x64, integrator, space):
    x, q = _cloud(seed=7, n=600, dtype=np.float64)
    x = x + 1.0
    periodic = space == "periodic"
    kw = dict(kernel="yukawa", kernel_params={"kappa": 0.8}, skin=0.03,
              theta=0.9, degree=2, leaf_size=16) if periodic else {}
    sim_kw = dict(dt=2e-4, refit_interval=4, integrator=integrator)
    sim = Simulation(_solver(space=PeriodicBox((L,) * 3) if periodic
                             else None, **kw).plan(x), q, **sim_kw)
    jsim = JSimulation(_jsolver(space=JBox((L,) * 3) if periodic else None,
                                **kw).plan(x, nranks=1), q, **sim_kw)
    sim.run(10, record_every=5)
    jsim.run(10, record_every=5)
    np.testing.assert_allclose(sim.state.x.numpy(), np.asarray(jsim.state.x),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sim.state.f.numpy(), np.asarray(jsim.state.f),
                               rtol=1e-9, atol=1e-9 * np.abs(
                                   np.asarray(jsim.state.f)).max())
    s, j = sim.stats(), jsim.stats()
    for key in ("steps", "refits", "rebuilds", "rebuilds_drift",
                "rebuilds_interval", "rebuilds_forced", "retraces",
                "compiles", "capacity_growths", "force_evals"):
        assert s[key] == j[key], (key, s[key], j[key])
    assert s["rebuilds"] >= 2 and s["refits"] >= 5
    np.testing.assert_allclose(
        [r["energy"] for r in sim.log.records],
        [r["energy"] for r in jsim.log.records], rtol=1e-9)


def test_diagnostics_match_reference(x64):
    x, q = _cloud(dtype=np.float64)
    r = np.random.default_rng(3)
    v = r.normal(0, 0.1, x.shape)
    f = r.normal(0, 1.0, x.shape)
    phi = r.normal(0, 1.0, x.shape[0])
    st = initial_state(torch.as_tensor(x), torch.as_tensor(v))
    st = st._replace(f=torch.as_tensor(f), phi=torch.as_tensor(phi))
    got = summarize(st, q, 2.0)
    jst = jdiag.summarize(
        type("S", (), dict(x=jnp.asarray(x), v=jnp.asarray(v),
                           f=jnp.asarray(f), phi=jnp.asarray(phi)))(),
        q, 2.0)
    for key, want in jst.items():
        np.testing.assert_allclose(got[key], want, rtol=1e-12, err_msg=key)


@pytest.mark.parametrize("skin", [0.0, 0.05])
def test_occupancy_counters_match_reference(x64, skin):
    x, _ = _cloud(n=900, dtype=np.float64)
    plan = _solver(skin=skin).plan(x, capacities="auto")
    jplan = _jsolver(skin=skin).plan(x, nranks=1, capacities="auto")
    got = occupancy_counters(plan.arrays, theta=0.8, space=plan.space,
                             skin=skin)
    want = j_occupancy(jplan.inner.arrays, theta=0.8,
                       space=jplan.config.space, skin=skin)
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key].item(), float(v), rtol=1e-6,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# integrators and the engine's contract
# ---------------------------------------------------------------------------


def test_engine_smoke_energy_refit_and_no_retraces():
    x, q = _cloud()
    sim = _sim(x, q, profile=True)
    sim.run(20, record_every=5)
    s = sim.stats()
    assert s["steps"] == 20 and s["refits"] >= 1
    assert s["retraces"] == 0 and s["compiles"] == 3   # advance/init/finish
    assert s["kernel_builds"] == 0 and s["capacity_growths"] == 0
    assert s["rebuilds"] == (s["rebuilds_drift"] + s["rebuilds_interval"]
                             + s["rebuilds_forced"]) <= 20 // 8 + 1
    assert sim.log.drift() < 1e-3 and sim.log.momentum_drift() < 1e-3
    assert 0.0 < s["occupancy"]["target_slot_occupancy"] <= 1.0
    assert s["plan"]["capacity_padded"]


def test_capacity_growth_is_one_counted_retrace():
    """A rebuild whose geometry overflows the budget grows it: one
    capacity growth and one retrace (new shapes), no more."""
    x, q = _cloud()
    solver = _solver()
    inner = solver.plan(x).inner
    caps = ev.Capacities.for_plan(inner, headroom=1.0)
    sim = Simulation(solver.plan(x, capacities=caps), q, dt=2e-4,
                     rebuild="always")
    sim.step()
    assert sim.stats()["retraces"] == 0
    # a dense clump: deeper tree, longer lists
    clump = torch.as_tensor(np.random.default_rng(0).normal(
        0, 0.05, x.shape).astype(np.float32))
    sim.state = sim.state._replace(x=clump)
    sim._x_eval_ref = clump
    sim.step()
    s = sim.stats()
    assert s["capacity_growths"] == 1 and s["retraces"] == 1
    sim.step()
    assert sim.stats()["retraces"] == 1


def test_drift_trigger_forces_rebuild():
    x, q = _cloud(n=900)
    sim = _sim(x, q, refit_interval=1000)
    assert np.isfinite(sim.stats()["mac_slack"])
    sim.state = sim.state._replace(
        x=sim.state.x + torch.tensor([0.5, 0.0, 0.0]))
    sim.step()
    assert sim.stats()["rebuilds_drift"] >= 1


def test_leapfrog_and_langevin_run():
    x, q = _cloud()
    lf = _sim(x, q, integrator="leapfrog")
    lf.run(6, record_every=3)
    assert lf.log.drift() < 1e-3
    lv = _sim(x, q, integrator="langevin",
              integrator_params=dict(friction=2.0, temperature=0.02))
    lv.run(6)
    d = lv.diagnostics()
    assert np.isfinite(d["temperature"]) and d["temperature"] > 0


def test_langevin_thermalizes_toward_target():
    """From a cold start BAOAB heats the system toward T (a statistical
    check: the OU noise is exact, so T lands within a broad band), and
    the same seed gives the same trajectory."""
    x, q = _cloud()
    temp = 0.05
    kw = dict(integrator="langevin", dt=5e-3, refit_interval=50,
              integrator_params=dict(friction=10.0, temperature=temp))
    sim = _sim(x, (q * 0.2).astype(np.float32), **kw)
    t0 = sim.diagnostics()["temperature"]
    sim.run(30)
    t1 = sim.diagnostics()["temperature"]
    assert t0 < 1e-12
    assert 0.5 * temp < t1 < 2.0 * temp
    again = _sim(x, (q * 0.2).astype(np.float32), **kw).run(3)
    other = _sim(x, (q * 0.2).astype(np.float32), seed=1, **kw).run(3)
    first = _sim(x, (q * 0.2).astype(np.float32), **kw).run(3)
    assert torch.equal(again.state.x, first.state.x)
    assert not torch.equal(other.state.x, first.state.x)


def test_integrator_registry_and_bad_args(monkeypatch):
    assert set(registered_integrators()) >= {
        "velocity_verlet", "leapfrog", "langevin"}
    assert "3.0" in get_integrator("langevin", friction=3.0).name
    with pytest.raises(KeyError):
        get_integrator("rk4")
    x, q = _cloud()
    with pytest.raises(ValueError):
        _sim(x, q, rebuild="sometimes")
    with pytest.raises(ValueError):
        _sim(x, q[:-1])
    with pytest.raises(ValueError):
        _sim(x, q, refit_interval=0)
    with pytest.raises(ValueError, match="device"):   # a host plan
        _sim(x, q, async_replan=True)
    with pytest.raises(TypeError):
        make_adapter(object())
    monkeypatch.delenv("REPRO_DEBUG_NANS", raising=False)
    sim = _sim(x, q)
    assert sim.debug_nans is False
    with pytest.raises(ValueError, match="checkpointer"):
        sim.save_checkpoint()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_resume_reproduces_trajectory(tmp_path):
    x, q = _cloud()
    ck = Checkpointer(str(tmp_path / "traj"))
    sim = _sim(x, q, checkpointer=ck, checkpoint_every=3,
               integrator="langevin",
               integrator_params=dict(friction=1.0, temperature=0.01))
    sim.run(6)
    ck.wait()
    x6 = sim.state.x.clone()
    sim.run(3)
    x9 = sim.state.x.clone()
    ck.wait()
    sim2 = _sim(x, q, checkpointer=Checkpointer(str(tmp_path / "traj")),
                integrator="langevin",
                integrator_params=dict(friction=1.0, temperature=0.01))
    assert sim2.restore_checkpoint(step=6) == 6
    torch.testing.assert_close(sim2.state.x, x6, rtol=0, atol=1e-6)
    sim2.run(3)
    # the noise generator's state rides in the checkpoint
    torch.testing.assert_close(sim2.state.x, x9, rtol=0, atol=5e-5)
    assert sim2.stats()["rebuilds_forced"] == 1
    assert Checkpointer(str(tmp_path / "none")).maybe_restore(
        {"a": torch.zeros(3)}) is None


def test_reference_checkpoint_restores_in_port(x64, tmp_path):
    """A trajectory checkpointed by `repro` continues in the port: the
    on-disk layout is the reference's, and the port re-anchors its tree
    at the restored positions."""
    x, q = _cloud(seed=11, n=500, dtype=np.float64)
    jck = JCheckpointer(str(tmp_path / "ref"))
    jsim = JSimulation(_jsolver().plan(x, nranks=1), q, dt=2e-4,
                       refit_interval=4, checkpointer=jck,
                       checkpoint_every=5)
    jsim.run(5)
    jck.wait()
    x5 = np.asarray(jsim.state.x)
    sim = Simulation(_solver().plan(x), q, dt=2e-4, refit_interval=4,
                     checkpointer=Checkpointer(str(tmp_path / "ref")))
    assert sim.restore_checkpoint() == 5
    np.testing.assert_array_equal(sim.state.x.numpy(), x5)
    np.testing.assert_array_equal(sim.state.v.numpy(),
                                  np.asarray(jsim.state.v))
    sim.run(3)
    jsim.restore_checkpoint(step=5)   # the same forced rebuild at step 5
    jsim.run(3)
    np.testing.assert_allclose(sim.state.x.numpy(), np.asarray(jsim.state.x),
                               rtol=1e-9, atol=1e-12)
    # and the port's checkpoints carry the reference's leaf names
    sim.checkpointer = Checkpointer(str(tmp_path / "port"))
    sim.save_checkpoint(background=False)
    tree, step, _ = JCheckpointer(str(tmp_path / "port")).restore(
        {k: v for k, v in jsim.state._asdict().items() if k != "key"})
    assert step == 8
    np.testing.assert_array_equal(np.asarray(tree["x"]),
                                  sim.state.x.numpy())


def test_padded_plan_dataclass_roundtrip():
    """`stats()["capacities"]` is the budget as a plain dict."""
    x, _ = _cloud()
    plan = _solver().plan(x, capacities="auto")
    caps = plan.capacities
    assert ev.Capacities(**plan.stats()["capacities"]) == caps
    assert dataclasses.asdict(caps)["num_chunks"] == caps.num_chunks

"""MD on a sharded plan: the port's `Simulation` over a P = 4 `ShardedPlan`
(stacked on the CPU) against `repro.dynamics.Simulation` over the
reference's `ShardedPlan` on the same seeded inputs.

The reference's sharded plan needs four JAX devices, so it runs once in a
subprocess with four host devices. Tolerances as the single-device MD
parity (`test_torch_dynamics.py`): a 10-step f64 trajectory with a
Verlet skin, whose refit interval forces a host rebuild, at rtol 1e-9 on
positions and energies, with the same refit, rebuild, retrace and
capacity-growth counts."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.dynamics import Simulation, make_adapter
from repro_torch.dynamics.refit import ShardedAdapter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(theta=0.8, degree=3, leaf_size=32, skin=0.03)
SIM = dict(dt=2e-4, refit_interval=6)
STEPS = 10
COUNTERS = ("steps", "refits", "rebuilds", "rebuilds_drift",
            "rebuilds_interval", "rebuilds_forced", "rebuilds_host",
            "retraces", "compiles", "capacity_growths", "force_evals")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n=1200):
    r = np.random.default_rng(11)
    return r.uniform(-1, 1, (n, 3)), 0.05 * r.uniform(-1, 1, n)


_REFERENCE = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro.core.api import TreecodeConfig, TreecodeSolver
from repro.dynamics import Simulation
out, kw, sim_kw, steps = sys.argv[1], *map(json.loads, sys.argv[2:5])
data = np.load(f"{out}/in.npz")
plan = TreecodeSolver(TreecodeConfig(backend="xla", **kw)).plan(
    data["x"], nranks=4)
sim = Simulation(plan, data["q"], **sim_kw)
sim.run(steps, record_every=5)
np.savez(f"{out}/ref.npz", x=np.asarray(sim.state.x),
         energy=np.array([r["energy"] for r in sim.log.records]),
         stats=json.dumps({k: v for k, v in sim.stats().items()
                           if isinstance(v, (int, float, str))}))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_md_ref")
    x, q = _cloud()
    np.savez(out / "in.npz", x=x, q=q)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
         json.dumps(KW), json.dumps(SIM), json.dumps(STEPS)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(out / "ref.npz"))
    ref["stats"] = json.loads(str(ref["stats"]))
    return ref


def test_sharded_simulation_matches_reference(reference):
    x, q = _cloud()
    plan = TreecodeSolver(TreecodeConfig(**KW), device="cpu").plan(
        x, nranks=4)
    adapter = make_adapter(plan)
    assert isinstance(adapter, ShardedAdapter)
    np.testing.assert_array_equal(adapter.positions().numpy(), x)
    sim = Simulation(plan, q, **SIM)
    sim.run(STEPS, record_every=5)
    np.testing.assert_allclose(sim.state.x.numpy(), reference["x"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose([r["energy"] for r in sim.log.records],
                               reference["energy"], rtol=1e-9)
    s, j = sim.stats(), reference["stats"]
    for key in COUNTERS:
        assert s[key] == j[key], (key, s[key], j[key])
    assert s["rebuilds"] == 1 and s["refits"] == STEPS - 1
    assert s["plan"]["strategy"] == "sharded"
    # the engine's synced arrays are the plan's: its refitted slab holds
    # the trajectory's current positions
    np.testing.assert_array_equal(sim.adapter.positions().numpy(),
                                  sim.state.x.numpy())


def test_sharded_rebuild_growth_recloses_and_async_raises():
    """A rebuild that outgrows the budget is a counted growth and
    re-closes the step over the new halo schedule; async replans need a
    device-built single plan, as in the reference."""
    r = np.random.default_rng(5)
    # a rod along x: RCB cuts three slabs, and the outer two are far
    # enough apart to need no halo from each other (offsets +-1 only)
    x = r.uniform(-1, 1, (600, 3)) * np.array([6.0, 0.3, 0.3])
    q = 0.05 * r.uniform(-1, 1, 600)
    plan = TreecodeSolver(TreecodeConfig(**KW), device="cpu").plan(
        x, nranks=3)
    assert plan.capacities.halo_offsets == (-1, 1)
    with pytest.raises(ValueError, match="async_replan"):
        Simulation(plan, q, async_replan=True, **SIM)
    sim = Simulation(plan, q, rebuild="always", **SIM)
    sim.run(2)
    st = sim.stats()
    assert st["capacity_growths"] == 0 and st["retraces"] == 0
    # squeezed into a cube, every rank borders every other: the next
    # rebuild widens the rounds to +-2
    sim.state = sim.state._replace(x=sim.state.x / torch.tensor(
        [6.0, 0.3, 0.3], dtype=torch.float64))
    sim.run(1)
    st = sim.stats()
    assert sim.plan.capacities.halo_offsets == (-2, -1, 1, 2)
    assert st["capacity_growths"] == 1 and st["retraces"] >= 1
    assert "halo_send_3" in sim.adapter.arrays
    assert np.isfinite(sim.state.f.numpy()).all()

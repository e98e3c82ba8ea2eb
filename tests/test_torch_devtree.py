"""The device tree build on the port (`repro_torch.devtree`), held against
`repro.devtree` on the same seeded inputs.

- Morton codes and the sort order: bitwise equal to
  `repro.devtree.morton.sort_phase`, free space and periodic, f64.
- The device plan: every integer array (leaf and batch tables, buckets,
  parents, gathers, the list lanes) equal to the reference's
  ``build_backend="device"`` plan, the boxes at rtol 1e-12 (f64), the
  same budget, on a dense tree, a periodic one with a Verlet skin and a
  deep one with sparse levels. The chunk table the build makes on the
  device equals the one `modified_charges.chunk_table` derives on the
  host.
- The port's device and host plans against an f64 direct sum (the twin
  of `tests/test_devtree.py::test_device_matches_host_against_f64_oracle`)
  and exact pair coverage on both.
- Budgeted replans: no new shapes and deterministic; a budget that is
  too small grows.
- MD: a 10-step f64 device-build `Simulation` against
  `repro.dynamics.Simulation` at rtol 1e-9, with the same counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.core.space import FREE as JFREE
from repro.core.space import PeriodicBox as JBox
from repro.devtree import build as jbuild
from repro.devtree import morton as jmorton
from repro.dynamics import Simulation as JSimulation
from repro_torch.core import eval as ev
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.space import FREE, PeriodicBox
from repro_torch.devtree import build as tbuild
from repro_torch.devtree import morton as tmorton
from repro_torch.dynamics import Simulation
from repro_torch.kernels.modified_charges import chunk_table
from repro_torch.obs import events

BOX, JBOX = PeriodicBox((1.0, 1.0, 1.0)), JBox((1.0, 1.0, 1.0))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed, periodic=False, dtype=np.float64):
    r = np.random.default_rng(seed)
    lo = 0.0 if periodic else -1.0
    return r.uniform(lo, 1.0, (n, 3)).astype(dtype)


def _solver(build_backend="device", space=None, **kw):
    cfg = dict(theta=0.7, degree=2, leaf_size=16, space=space,
               build_backend=build_backend)
    cfg.update(kw)
    return TreecodeSolver(TreecodeConfig(**cfg), device="cpu")


def _np(v):
    return tuple(np.asarray(a) for a in v) if isinstance(v, tuple) \
        else np.asarray(v)


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------


def _ref_interleave(ux, uy, uz, bits):
    out = 0
    for b in range(bits):
        out |= (((ux >> b) & 1) << (3 * b + 2)
                | ((uy >> b) & 1) << (3 * b + 1)
                | ((uz >> b) & 1) << (3 * b))
    return out


@pytest.mark.parametrize("periodic", [False, True], ids=["free", "periodic"])
def test_sort_phase_bitwise_equals_reference(x64, periodic):
    x = _cloud(20000, 3, periodic) * (1.3 if periodic else 1.0)
    got = tmorton.sort_phase(torch.as_tensor(x),
                             space=BOX if periodic else FREE)
    want = jmorton.sort_phase(jnp.asarray(x),
                              space=JBOX if periodic else JFREE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # codes against a bit-by-bit interleave
    u = np.random.default_rng(0).integers(0, 1 << tmorton.BITS, (256, 3))
    u = torch.as_tensor(u, dtype=torch.int32)
    codes = tmorton.interleave3(u[:, 0], u[:, 1], u[:, 2]).tolist()
    assert codes == [_ref_interleave(*map(int, r), tmorton.BITS) for r in u]


# ---------------------------------------------------------------------------
# The device plan against the reference's
# ---------------------------------------------------------------------------

_CASES = {
    "dense": dict(n=1200, periodic=False, skin=0.0, kw=dict(leaf_size=16)),
    "periodic_skin": dict(n=1200, periodic=True, skin=0.05,
                          kw=dict(leaf_size=16)),
    # depth 6 over leaves of 4: two sparse source levels, one target
    "sparse": dict(n=1500, periodic=False, skin=0.02,
                   kw=dict(leaf_size=4), depth=(6, 5)),
}


def _plans(case):
    """(port plan, reference plan) of `case`, f64 device builds."""
    c = _CASES[case]
    x = _cloud(c["n"], 5, c["periodic"])
    kw = dict(theta=0.7, degree=2, skin=c["skin"], **c["kw"])
    space, jspace = (BOX, JBOX) if c["periodic"] else (FREE, JFREE)
    if "depth" not in c:
        plan = _solver(space=space, dtype="float64", **kw).plan(x).inner
        jplan = JSolver(JConfig(backend="xla", space=jspace,
                                build_backend="device", dtype="float64",
                                **kw)).plan(x, nranks=1).inner
        return plan, jplan, x
    d, bd = c["depth"]
    kw = dict(theta=0.7, degree=2, leaf_size=kw["leaf_size"],
              batch_size=kw["leaf_size"], skin=c["skin"], depth=d,
              batch_depth=bd)
    t = torch.as_tensor(x)
    plan = tbuild.prepare_plan_device(t, t, space=space, **kw)
    jplan = jbuild.prepare_plan_device(x, x, space=jspace, **kw)
    return plan, jplan, x


@pytest.fixture(scope="module")
def device_plans():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return {case: _plans(case) for case in _CASES}
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("case", list(_CASES))
def test_device_plan_equals_reference(device_plans, case):
    plan, jplan, _ = device_plans[case]
    caps, jcaps = plan.capacities, jplan.capacities
    for f in dataclasses.fields(jcaps):
        if hasattr(caps, f.name):
            assert getattr(caps, f.name) == getattr(jcaps, f.name), f.name
    assert plan.dev["pair_caps"] == jplan.dev["pair_caps"]
    if case == "sparse":
        assert len(caps.sparse_rows) == 2 and len(caps.batch_sparse_rows) == 1
    ja = {k: _np(v) for k, v in jplan.arrays.items()}
    for k, want in ja.items():
        got = _np(plan.arrays[k])
        if isinstance(want, tuple):
            assert len(got) == len(want), k
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=k)
        elif want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    for k in ("node_count", "node_start", "node_active", "node_leaf",
              "node_code", "leaf_ids", "b_start", "b_count"):
        np.testing.assert_array_equal(_np(plan.dev[k]), _np(jplan.dev[k]),
                                      err_msg=k)
    assert plan.dev["sparse_occ"] == tuple(jplan.dev["sparse_occ"])
    np.testing.assert_allclose(plan.theta_slack, jplan.theta_slack,
                               rtol=1e-12)
    np.testing.assert_allclose(plan.fold_slack, jplan.fold_slack,
                               rtol=1e-12)
    # the chunk table built on the device = the host's over the buckets
    chunks, ptr = chunk_table(*ev.node_ranges(
        {k: _np(v) for k, v in plan.arrays.items()}))
    a = plan.arrays
    np.testing.assert_array_equal(a["mc_chunks"][:len(chunks)].numpy(),
                                  chunks)
    assert (a["mc_chunks"][len(chunks):, 0] == caps.scratch_node).all()
    assert (a["mc_chunks"][len(chunks):, 1:] == 0).all()
    np.testing.assert_array_equal(a["mc_chunk_ptr"].numpy(), ptr)
    assert a["mc_chunks"].shape[0] == caps.num_chunks


@pytest.mark.parametrize("case", list(_CASES))
def test_lazy_host_trees_equal_reference(device_plans, case):
    """The host `Tree` / `Batches` a device plan builds on first touch:
    leaf ranges tile [0, N) as in the reference's."""
    plan, jplan, _ = device_plans[case]
    assert plan.tree._obj is None
    tree, jtree = plan.tree, jplan.tree
    for k in ("start", "count", "level", "parent", "children", "leaf_ids",
              "perm", "is_leaf"):
        np.testing.assert_array_equal(getattr(tree, k), getattr(jtree, k),
                                      err_msg=k)
    np.testing.assert_allclose(tree.lo, jtree.lo, rtol=1e-12)
    for k in ("start", "count", "perm"):
        np.testing.assert_array_equal(getattr(plan.batches, k),
                                      getattr(jplan.batches, k), err_msg=k)


# ---------------------------------------------------------------------------
# Device and host plans against an f64 oracle; exact pair coverage
# ---------------------------------------------------------------------------


def _oracle(x, q, space):
    xd = x.astype(np.float64)
    d = xd[:, None, :] - xd[None, :, :]
    if space.periodic:
        d -= np.asarray(space.lengths) * np.round(d / space.lengths)
    r2 = (d ** 2).sum(-1)
    np.fill_diagonal(r2, np.inf)
    return (q.astype(np.float64)[None, :] / np.sqrt(r2)).sum(-1)


@pytest.mark.parametrize("space", [FREE, BOX], ids=["free", "periodic"])
def test_device_and_host_match_f64_oracle(space):
    x = _cloud(1200, 9, space.periodic, np.float32)
    q = np.random.default_rng(9).uniform(0.5, 1.5, 1200).astype(np.float32)
    ref = _oracle(x, q, space)
    scale = np.abs(ref).max()
    errs = {}
    for backend in ("host", "device"):
        plan = _solver(backend, space=space, skin=0.05,
                       leaf_size=32).plan(x)
        errs[backend] = np.abs(plan.execute(q).numpy() - ref).max() / scale
    assert errs["device"] <= max(2.0 * errs["host"], 1e-5), errs


def _coverage(inner):
    """(target, source) coverage counts of a plan's lists."""
    tree, batches, a = inner.tree, inner.batches, inner.arrays
    approx, direct = a["approx_idx"].numpy(), a["direct_idx"].numpy()
    leaf_gather = a["leaf_gather"].numpy()
    m = np.zeros((inner.num_targets, inner.num_sources), np.int64)
    for b in range(batches.num_batches):
        t = batches.perm[batches.start[b]:batches.start[b]
                         + batches.count[b]]
        srcs = [tree.perm[tree.start[g]:tree.start[g] + tree.count[g]]
                for g in approx[b] if g >= 0]
        srcs += [tree.perm[leaf_gather[s][leaf_gather[s] >= 0]]
                 for s in direct[b] if s >= 0]
        if srcs:
            flat = np.concatenate(srcs)
            np.add.at(m, (np.repeat(t, flat.size), np.tile(flat, t.size)), 1)
    return m


@pytest.mark.parametrize("space", [FREE, BOX], ids=["free", "periodic"])
def test_pair_coverage_exact_on_both_builds(space):
    x = _cloud(600, 4, space.periodic, np.float32)
    for backend in ("host", "device"):
        plan = _solver(backend, space=space, degree=1, leaf_size=8).plan(x)
        assert (_coverage(plan.inner) == 1).all(), backend


# ---------------------------------------------------------------------------
# Budgeted replans
# ---------------------------------------------------------------------------


def test_budgeted_replan_keeps_shapes_and_is_deterministic():
    x = _cloud(1500, 6, dtype=np.float32)
    q = np.random.default_rng(6).uniform(-1, 1, 1500).astype(np.float32)
    plan = _solver(leaf_size=32).plan(x)
    assert plan.stats()["build_backend"] == "device"
    assert plan.inner.tree._obj is None      # stats built no host tree
    compiles = events.log.count(owner="devtree", kind="compile")
    p2 = plan.replan(x)
    assert events.log.count(owner="devtree", kind="compile") == compiles
    assert ev.plan_signature(p2.inner) == ev.plan_signature(plan.inner)
    assert p2.inner.dev["pair_caps"] == plan.inner.dev["pair_caps"]
    assert torch.equal(plan.execute(q), p2.execute(q))
    for k, v in plan.arrays.items():
        if not isinstance(v, tuple):
            assert torch.equal(v, p2.arrays[k]), k
    # moved particles: a budgeted replan, still no new shape
    p3 = plan.replan(x + 0.002)
    assert ev.plan_signature(p3.inner) == ev.plan_signature(plan.inner)
    assert events.log.count(owner="devtree", kind="compile") == compiles


def test_too_small_budget_grows():
    x = _cloud(1500, 8, dtype=np.float32)
    q = np.random.default_rng(8).uniform(-1, 1, 1500).astype(np.float32)
    plan = _solver(leaf_size=32).plan(x)
    ref = plan.execute(q)
    caps = plan.capacities
    small = dataclasses.replace(caps, approx_width=8, direct_width=16,
                                num_chunks=8)
    growths = events.log.count(owner="devtree", kind="capacity_growth")
    p2 = plan.replan(x, capacities=small)
    assert events.log.count(owner="devtree",
                            kind="capacity_growth") > growths
    assert p2.capacities.approx_width >= caps.approx_width
    assert p2.capacities.num_chunks >= caps.num_chunks - 8
    torch.testing.assert_close(p2.execute(q), ref, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# MD with device rebuilds against the reference
# ---------------------------------------------------------------------------


def test_device_rebuild_simulation_matches_reference_f64(x64):
    """Periodic, with a Verlet skin: rebuilds wrap on the device."""
    r = np.random.default_rng(7)
    x = r.uniform(0.0, 2.0, (600, 3))
    q = 0.05 * r.uniform(-1, 1, 600)
    kw = dict(theta=0.8, degree=3, leaf_size=32, build_backend="device",
              skin=0.03)
    sim_kw = dict(dt=2e-4, refit_interval=4)
    box, jbox = PeriodicBox((2.0,) * 3), JBox((2.0,) * 3)
    sim = Simulation(TreecodeSolver(TreecodeConfig(space=box, **kw),
                                    device="cpu").plan(x), q, **sim_kw)
    jsim = JSimulation(JSolver(JConfig(backend="xla", space=jbox, **kw))
                       .plan(x, nranks=1), q, **sim_kw)
    sim.run(10, record_every=5)
    jsim.run(10, record_every=5)
    np.testing.assert_allclose(sim.state.x.numpy(), np.asarray(jsim.state.x),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sim.state.f.numpy(), np.asarray(jsim.state.f),
                               rtol=1e-9, atol=1e-9 * np.abs(
                                   np.asarray(jsim.state.f)).max())
    s, j = sim.stats(), jsim.stats()
    for key in ("steps", "refits", "rebuilds", "rebuilds_drift",
                "rebuilds_interval", "rebuilds_forced", "rebuilds_host",
                "devtree_rebuilds", "retraces", "compiles",
                "capacity_growths", "force_evals", "build_backend"):
        assert s[key] == j[key], (key, s[key], j[key])
    assert s["devtree_rebuilds"] == s["rebuilds"] >= 2
    assert s["rebuild_wait_ms"] == pytest.approx(s["rebuild_total_ms"])
    np.testing.assert_allclose(
        [rec["energy"] for rec in sim.log.records],
        [rec["energy"] for rec in jsim.log.records], rtol=1e-9)

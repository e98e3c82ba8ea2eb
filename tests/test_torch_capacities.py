"""Capacity padding: `Capacities`, `pad_plan`, `plan_signature` and growth
against `repro`'s on the same plan, and the port's padded chunk table.

The planner is bitwise equal to the reference's, so the same points give
the same capacities and, key for key, the same padded arrays; the port's
extra keys are the modified charges' chunk table (`mc_chunks`,
`mc_chunk_ptr`), budgeted by `Capacities.num_chunks`. Padded plans give
the same potentials and forces as unpadded ones (every padded slot is
masked), here exactly: the padding adds only zero terms."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import eval as jev
from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro_torch.core import eval as ev
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.space import PeriodicBox
from repro_torch.kernels import ops

KW = dict(theta=0.8, degree=3, leaf_size=32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps OpenMP from spinning
    against the other test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cloud():
    r = np.random.default_rng(1234)
    return (r.uniform(-1, 1, (900, 3)).astype(np.float32),
            r.uniform(-1, 1, 900).astype(np.float32))


def _solver(**kw):
    return TreecodeSolver(TreecodeConfig(**dict(KW, **kw)), device="cpu")


def _np(v):
    return tuple(np.asarray(x) for x in v) if isinstance(v, tuple) \
        else np.asarray(v)


@pytest.mark.parametrize("skin", [0.0, 0.05])
def test_pad_plan_matches_reference(cloud, skin):
    x, _ = cloud
    plan = _solver(skin=skin).plan(x, capacities="auto")
    jplan = JSolver(JConfig(backend="xla", skin=skin, **KW)).plan(
        x, nranks=1, capacities="auto")
    caps, jcaps = plan.capacities, jplan.capacities
    shared = [f.name for f in dataclasses.fields(caps)
              if hasattr(jcaps, f.name)]
    # + the chunk tables' budgets, num_chunks and num_leaf_chunks
    assert len(shared) == len(dataclasses.fields(caps)) - 2
    for name in shared:
        assert getattr(caps, name) == getattr(jcaps, name), name
    for key, v in plan.arrays.items():
        if key in ev.CHUNK_KEYS:
            continue
        got, want = _np(v), _np(jplan.arrays[key])
        if isinstance(got, tuple):
            assert len(got) == len(want), key
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    # the signature: the reference's shapes, plus the chunk budget
    sig = {k: v for k, v in ev.plan_signature(plan.inner)}
    jsig = {k: v for k, v in jev.plan_signature(jplan.inner)}
    assert set(sig) - set(jsig) == set(ev.CHUNK_KEYS)

    def shapes(v):      # (shape, dtype) of an array, or a tuple of them
        return [tuple(v[0])] if isinstance(v[1], str) \
            else [tuple(s) for s, _ in v]

    for key, v in jsig.items():
        assert shapes(sig[key]) == shapes(v), key
    assert sig["mc_chunks"][0] == (caps.num_chunks, 3)
    assert sig["mc_chunk_ptr"][0] == (caps.num_nodes + 1,)


@pytest.mark.parametrize("space", ["free", "periodic"])
def test_padded_execute_and_forces_equal_unpadded(cloud, space):
    x, q = cloud
    box = PeriodicBox((2.0, 2.0, 2.0), origin=(-1.0, -1.0, -1.0)) \
        if space == "periodic" else None
    solver = _solver(space=box, skin=0.03)
    plain = solver.plan(x)
    padded = solver.plan(x, capacities="auto")
    assert padded.capacities is not None
    st = padded.stats()
    assert st["capacity_padded"] and not plain.stats()["capacity_padded"]
    assert st["capacities"]["num_chunks"] == padded.capacities.num_chunks
    assert "pad" in st["build_phases"]
    torch.testing.assert_close(padded.execute(q), plain.execute(q),
                               rtol=0, atol=0)
    for a, b in zip(padded.potential_and_forces(q),
                    plain.potential_and_forces(q)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_padded_chunk_table_gives_zero_qhat(cloud):
    """Scratch and padded nodes own no chunk; padded chunk rows are empty
    ranges owned by the scratch node: their q_hat is exactly 0, and the
    real nodes' q_hat is the unpadded plan's."""
    x, q = cloud
    plain = _solver().plan(x)
    padded = _solver().plan(x, capacities="auto")
    a, caps = padded.arrays, padded.capacities
    n_real = plain.arrays["node_lo"].shape[0]
    k_real = plain.arrays["mc_chunks"].shape[0]
    ptr, chunks = a["mc_chunk_ptr"], a["mc_chunks"]
    assert ptr.shape == (caps.num_nodes + 1,)
    assert (ptr[n_real:] == ptr[n_real]).all() and ptr[n_real] == k_real
    assert chunks.shape == (caps.num_chunks, 3)
    assert (chunks[k_real:, 0] == caps.scratch_node).all()
    assert (chunks[k_real:, 1] == chunks[k_real:, 2]).all()
    qt = torch.as_tensor(q)
    qhat = [ops.modified_charges_ranged(
        p.arrays["src_sorted"], qt[p.arrays["src_perm"]],
        p.arrays["mc_chunks"], p.arrays["mc_chunk_ptr"], p.arrays["node_lo"],
        p.arrays["node_hi"], degree=KW["degree"], backend="torch")
        for p in (plain, padded)]
    assert (qhat[1][n_real:] == 0).all()
    torch.testing.assert_close(qhat[1][:n_real], qhat[0], rtol=0, atol=0)


def test_capacity_replan_is_shape_stable(cloud):
    x, q = cloud
    rng = np.random.default_rng(7)
    plan = _solver().plan(x, capacities="auto")
    sig0 = ev.plan_signature(plan.inner)
    for scale in (0.005, 0.01, 0.02):
        x = x + rng.normal(0, scale, x.shape).astype(np.float32)
        plan = plan.replan(x)            # capacities="keep"
        assert ev.plan_signature(plan.inner) == sig0
        assert plan.capacities is not None
    fresh = _solver().plan(x)
    torch.testing.assert_close(plan.execute(q), fresh.execute(q),
                               rtol=1e-4, atol=1e-4)
    assert plan.replan(x, capacities=None).capacities is None


def test_capacity_growth_is_geometric_and_fits(cloud):
    """The reference's growth rule, the chunk budget included, on the same
    plan: equal grown capacities on the shared fields."""
    x, _ = cloud
    plan = _solver().plan(x)
    jplan = JSolver(JConfig(backend="xla", **KW)).plan(x, nranks=1)
    caps = ev.Capacities.for_plan(plan.inner)
    jcaps = jev.Capacities.for_plan(jplan.inner)
    assert caps.fits(plan.inner)
    tight = dataclasses.replace(caps, approx_width=1, num_chunks=1,
                                bucket_rows=caps.bucket_rows[:-1])
    jtight = dataclasses.replace(jcaps, approx_width=1,
                                 bucket_rows=jcaps.bucket_rows[:-1])
    assert not tight.fits(plan.inner)
    grown = tight.grown_to_fit(plan.inner)
    jgrown = jtight.grown_to_fit(jplan.inner)
    assert grown.approx_width > tight.approx_width
    assert grown.num_chunks >= plan.arrays["mc_chunks"].shape[0] > 1
    assert grown.fits(plan.inner) and grown.grown_to_fit(plan.inner) == grown
    for f in dataclasses.fields(grown):
        if hasattr(jgrown, f.name):
            assert getattr(grown, f.name) == getattr(jgrown, f.name), f.name
    # another budget, other shapes
    padded = ev.pad_plan(plan.inner, grown)
    assert ev.plan_signature(padded) != ev.plan_signature(
        ev.pad_plan(plan.inner, caps))
    with pytest.raises(ValueError, match="grown_to_fit"):
        ev.pad_plan(plan.inner, tight)


def test_point_budgets_and_unknown_capacities_raise(cloud):
    x, _ = cloud
    plan = _solver().plan(x)
    need = ev._plan_dims(plan.inner)
    # point budgets (the serving setting) work: a needs dict with point
    # keys enables them and reserves the scratch batch row
    pts = ev.Capacities.for_need(dict(need, num_targets=900,
                                      num_sources=900))
    assert pts.points_budgeted and pts.num_targets >= 900
    assert pts.scratch_batch == pts.num_batches - 1
    assert pts.num_batches > ev.Capacities.for_need(need).num_batches
    caps = ev.Capacities.for_plan(plan.inner)
    assert not caps.points_budgeted
    wide = dataclasses.replace(caps, num_targets=1024, num_sources=1024)
    assert wide.points_budgeted and wide.grown_to_fit_need(
        dict(need, num_targets=2000, num_sources=2000)).num_targets >= 2000
    with pytest.raises(TypeError, match="Capacities"):
        plan.replan(x, capacities=object())
    with pytest.raises(ValueError, match="capacities"):
        plan.replan(x, capacities="big")

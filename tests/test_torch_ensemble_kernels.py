"""The systems axis of the port's kernels and the point budgets behind it.

- Every plain kernel (the CPU path, and each CUDA kernel's yardstick)
  given a leading systems axis W equals W separate single-system calls,
  bitwise: ragged per-system counts, per-system Yukawa kappas, a system
  of zero charges and a point-padded scratch batch row (exactly 0).
- `pack_params` packs per-system values into (W, P) rows.
- Point budgets: `Capacities.for_need` / `grown_to_fit_need` with point
  keys give the reference's values, and `pad_plan`'s point branch gives
  the reference's integer arrays bitwise (`gather_index`, `src_perm`,
  the gather tables and lists).
- The stacked pipeline: an ensemble of one padded plan executes bitwise
  as the plan itself, and the stacked refit equals per-system refits.
"""
import numpy as np
import pytest
import torch

from repro.core import eval as jev
from repro_torch.core import eval as ev
from repro_torch.core.potentials import coulomb, pack_params, yukawa
from repro_torch.core.space import FREE, PeriodicBox
from repro_torch.dynamics.refit import refit_single_arrays
from repro_torch.kernels import ops
from repro_torch.kernels.modified_charges import chunk_table

W, B, S, NB, C, M = 3, 4, 5, 24, 6, 20
BOX = PeriodicBox((2.0, 2.0, 2.0), origin=(-1.0, -1.0, -1.0))


def _stack(rng, dtype):
    """Stacked batch-cluster operands: system 1 has zero charges, the
    last batch row of every system is an all-padding scratch row."""
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    idx = torch.as_tensor(rng.integers(-1, C, (W, B, S)), dtype=torch.int32)
    tgt = t(rng.uniform(-1, 1, (W, B, NB, 3)))
    src = t(rng.uniform(-1, 1, (W, C, M, 3)))
    q = t(rng.uniform(-1, 1, (W, C, M)))
    q[1] = 0.0
    tgt_count = torch.as_tensor(rng.integers(0, NB + 1, (W, B)),
                                dtype=torch.int32)
    tgt_count[:, -1] = 0                                 # scratch row
    src_count = torch.as_tensor(rng.integers(0, M + 1, (W, C)),
                                dtype=torch.int32)
    return idx, tgt, src, q, tgt_count, src_count


@pytest.mark.parametrize("fn", ["eval", "field", "grid_field"])
@pytest.mark.parametrize("space", ["free", "periodic"])
def test_plain_kernels_with_systems_axis_equal_separate_calls(fn, space):
    rng = np.random.default_rng(0)
    dtype = torch.float64
    idx, tgt, src, q, tc, sc = _stack(rng, dtype)
    kern = yukawa()
    kappa = torch.tensor([0.5, 1.3, 2.0], dtype=dtype)
    sp = FREE if space == "free" else BOX
    degree = 2
    n1 = degree + 1
    lo = torch.as_tensor(rng.uniform(-1, -0.2, (W, C, 3)), dtype=dtype)
    hi = torch.as_tensor(rng.uniform(0.2, 1, (W, C, 3)), dtype=dtype)
    nodes = ops._cluster_nodes(lo, hi, degree)
    qhat = torch.as_tensor(rng.uniform(-1, 1, (W, C, n1 ** 3)), dtype=dtype)

    def call(i=None):
        pick = (lambda t: t) if i is None else (lambda t: t[i])  # noqa
        params = (kappa if i is None else kappa[i],)
        kw = dict(kernel=kern, space=sp, backend="torch",
                  tgt_count=pick(tc))
        if fn == "grid_field":
            return ops.batch_cluster_field_grid(
                pick(idx), pick(tgt), pick(nodes), pick(qhat), params, **kw)
        op = ops.batch_cluster_eval if fn == "eval" \
            else ops.batch_cluster_field
        return op(pick(idx), pick(tgt), pick(src), pick(q), params,
                  src_count=pick(sc), **kw)

    got = call()
    assert got.shape[:3] == (W, B, NB)
    for i in range(W):
        assert torch.equal(got[i], call(i)), f"system {i}"
    assert (got[:, -1] == 0).all(), "the scratch batch row"
    if fn != "grid_field":
        assert (got[1] == 0).all(), "a system of zero charges"


def test_plain_modified_charges_with_systems_axis_equal_separate_calls():
    rng = np.random.default_rng(1)
    degree, n = 3, 90
    counts = [np.array([0, 30, 1, 59]), np.array([45, 45, 0, 0]),
              np.array([90, 0, 0, 0])]
    tables = [chunk_table(np.concatenate([[0], np.cumsum(c)[:-1]]), c,
                          chunk=16) for c in counts]
    k = max(t[0].shape[0] for t in tables)
    chunks = np.stack([np.concatenate([t[0], np.tile([[3, 0, 0]],
                                                     (k - len(t[0]), 1))])
                       for t in tables])
    ptr = np.stack([t[1] for t in tables])
    pts = torch.as_tensor(rng.uniform(-1, 1, (3, n, 3)))
    q = torch.as_tensor(rng.uniform(-1, 1, (3, n)))
    lo = torch.full((3, 4, 3), -1.0, dtype=torch.float64)
    hi = torch.full((3, 4, 3), 1.0, dtype=torch.float64)
    args = (torch.as_tensor(chunks), torch.as_tensor(ptr), lo, hi)
    got = ops.modified_charges_ranged(pts, q, *args, degree=degree,
                                      backend="torch")
    assert got.shape == (3, 4, (degree + 1) ** 3)
    for i in range(3):
        want = ops.modified_charges_ranged(
            pts[i], q[i], *(a[i] for a in args), degree=degree,
            backend="torch")
        assert torch.equal(got[i], want)
    assert (got[2, 1:] == 0).all() and (got[0, 0] == 0).all()


def test_pack_params_stacked_form():
    kappa = torch.tensor([0.5, 1.0, 2.0])
    par = pack_params((kappa,), dtype=torch.float64, device="cpu",
                      systems=3)
    assert par.shape == (3, 1) and par[:, 0].tolist() == [0.5, 1.0, 2.0]
    shared = pack_params((0.7,), dtype=torch.float32, device="cpu",
                         systems=2)
    assert shared.shape == (2, 1) and (shared == 0.7).all()
    empty = pack_params(coulomb().params, dtype=torch.float32, device="cpu",
                        systems=4)
    assert empty.shape == (4, 1) and (empty == 0).all()


@pytest.fixture(scope="module")
def plans():
    """(port plan, reference plan) over one f64 cloud, and its points."""
    import jax
    r = np.random.default_rng(5)
    x = r.uniform(-1, 1, (260, 3))
    kw = dict(theta=0.7, degree=3, leaf_size=16, batch_size=16, skin=0.02)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jplan = jev.prepare_plan(x, x, **kw)
        need = dict(jev._plan_dims(jplan), num_targets=300, num_sources=300)
        jcaps = jev.Capacities.for_need(need, headroom=1.0, base=1)
        jpad = jev.pad_plan(jplan, jcaps)
        jarrays = {k: (tuple(np.asarray(a) for a in v)
                       if isinstance(v, tuple) else np.asarray(v))
                   for k, v in jpad.arrays.items()}
        jgrown = jcaps.grown_to_fit_need(dict(need, num_targets=500,
                                              num_sources=480))
    finally:
        jax.config.update("jax_enable_x64", prev)
    plan = ev.prepare_plan(x, x, device="cpu", **kw)
    return plan, jcaps, jarrays, jgrown, x


FIELDS = ("num_targets", "num_sources", "num_batches", "batch_width",
          "num_leaves", "leaf_width", "num_nodes", "approx_width",
          "direct_width", "skin_direct_width", "depth", "bucket_rows",
          "bucket_widths", "headroom", "growth")


def test_point_budgets_equal_reference(plans):
    plan, jcaps, _, jgrown, _ = plans
    need = dict(ev._plan_dims(plan), num_targets=300, num_sources=300)
    caps = ev.Capacities.for_need(need, headroom=1.0, base=1)
    grown = caps.grown_to_fit_need(dict(need, num_targets=500,
                                        num_sources=480))
    for f in FIELDS:
        assert getattr(caps, f) == getattr(jcaps, f), f
        assert getattr(grown, f) == getattr(jgrown, f), f
    assert caps.points_budgeted and caps.scratch_batch == jcaps.scratch_batch
    assert caps.fits(plan) and not ev.Capacities.for_need(
        ev._plan_dims(plan)).points_budgeted
    small = ev.Capacities.for_need(dict(need, num_targets=100,
                                        num_sources=100))
    with pytest.raises(ValueError, match="point budget"):
        ev.pad_plan(plan, small)


def test_pad_plan_point_branch_is_bitwise_the_reference(plans):
    plan, _, jarrays, _, _ = plans
    need = dict(ev._plan_dims(plan), num_targets=300, num_sources=300)
    caps = ev.Capacities.for_need(need, headroom=1.0, base=1)
    a = ev.pad_plan(plan, caps).arrays
    assert a["gather_index"][-1] == caps.scratch_batch * caps.batch_width
    for key in ("gather_index", "src_perm", "leaf_gather", "approx_idx",
                "direct_idx", "skin_direct", "skin_direct_node",
                "parent_of", "tgt_mask", "approx_skin"):
        assert np.array_equal(a[key].numpy(), jarrays[key]), key
    for key in ("bucket_gather", "bucket_nodes"):
        assert len(a[key]) == len(jarrays[key])
        for got, want in zip(a[key], jarrays[key]):
            assert np.array_equal(got.numpy(), want), key
    assert np.array_equal(a["src_sorted"].numpy(), jarrays["src_sorted"])
    # padded particles own no chunk: the chunk table is the unpadded one
    assert int(a["mc_chunks"][:, 2].max()) <= plan.num_sources
    assert (a["mc_chunk_ptr"][-1] == plan.arrays["mc_chunk_ptr"][-1]).all()


def test_stacked_pipeline_equals_the_single_plan(plans):
    plan, _, _, _, x = plans
    need = dict(ev._plan_dims(plan), num_targets=300, num_sources=300)
    caps = ev.Capacities.for_need(need, headroom=1.0, base=1)
    padded = ev.pad_plan(plan, caps)
    q = torch.as_tensor(np.random.default_rng(6).uniform(-1, 1, 300))
    q[260:] = 0.0
    opts = dict(degree=3, kernel=coulomb(), theta=0.7, skin=0.02)
    one = ev.execute(padded.arrays, q, **opts)
    stack = {k: (tuple(t[None] for t in v) if isinstance(v, tuple)
                 else v[None]) for k, v in padded.arrays.items()}
    assert torch.equal(ev.ensemble_execute(stack, q[None], **opts)[0], one)
    assert (one[260:] == 0).all()
    phi, f = ev.ensemble_potential_and_forces(stack, q[None], q[None],
                                              **opts)
    assert (f[0, 260:] == 0).all()
    # the stacked refit is the single refit of each system
    xs = torch.zeros((2, 300, 3), dtype=torch.float64)
    xs[0, :260] = torch.as_tensor(x) * 0.99
    xs[1, :260] = torch.as_tensor(x) * 1.01
    two = {k: (tuple(torch.cat([t[None]] * 2) for t in v)
               if isinstance(v, tuple) else torch.cat([v[None]] * 2))
           for k, v in padded.arrays.items()}
    got = refit_single_arrays(two, xs)
    for i in range(2):
        want = refit_single_arrays(padded.arrays, xs[i])
        for k in ("src_sorted", "node_lo", "node_hi", "tgt_batched"):
            assert torch.equal(got[k][i], want[k]), (k, i)

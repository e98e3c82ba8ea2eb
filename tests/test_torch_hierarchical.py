"""The hierarchical precompute on the port, held against `repro`.

`compute_qhat_hierarchical` takes the leaves' modified charges from their
particles (one ranged call over the leaves' chunk table) and every
internal cluster's from its children (the exact Chebyshev-to-Chebyshev
restriction, one einsum per level). The port's planner is bitwise the
reference's, so both packages see the same tree: q_hat agrees at f64
rtol 1e-10 (positive charges, so no entry cancels towards 0), and with
the direct precompute too (the restriction is exact), so the potentials
equal the direct precompute's. Padding into capacities keeps the results (the twin of
`tests/test_dynamics.py::test_capacity_padding_preserves_hierarchical`),
and a device build refuses the hierarchical precompute, as in the
reference."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as jev
from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro_torch.configs import bltc
from repro_torch.core import eval as ev
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.kernels.modified_charges import chunk_table

KW = dict(theta=0.7, degree=4, leaf_size=48, precompute="hierarchical")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    r = np.random.default_rng(11)
    return r.uniform(-1, 1, (2500, 3)), r.uniform(0.5, 1.5, 2500)


@pytest.fixture(scope="module")
def plans(cloud):
    """(port plan, reference plan) over one f64 cloud."""
    import jax
    x, _ = cloud
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jplan = JSolver(JConfig(backend="xla", **KW)).plan(x, nranks=1)
        jarrays = {k: (tuple(np.asarray(a) for a in v)
                       if isinstance(v, tuple) else np.asarray(v))
                   for k, v in jplan.inner.arrays.items()}
    finally:
        jax.config.update("jax_enable_x64", prev)
    plan = TreecodeSolver(TreecodeConfig(dtype="float64", **KW),
                          device="cpu").plan(x)
    return plan, jarrays


def _qhat(arrays, q, precompute):
    q_sorted = torch.as_tensor(q)[arrays["src_perm"]]
    fn = (ev.compute_qhat_hierarchical if precompute == "hierarchical"
          else ev.compute_qhat_direct)
    return fn(arrays, q_sorted, degree=KW["degree"], backend="torch")


def test_tables_match_reference(plans):
    plan, jarrays = plans
    a = plan.arrays
    assert len(a["upward_pairs"]) == len(jarrays["upward_pairs"])
    for got, want in zip(a["upward_pairs"], jarrays["upward_pairs"]):
        np.testing.assert_array_equal(got.numpy(), want)
    # each parent's children listed once, in pair order, on its first row
    for pairs, kids in zip(a["upward_pairs"], a["upward_children"]):
        parents, kids = pairs[:, 0].numpy(), kids.numpy()
        for p in np.unique(parents):
            rows = np.flatnonzero(parents == p)
            np.testing.assert_array_equal(kids[rows[0], :len(rows)], rows)
            assert (kids[rows[0], len(rows):] == -1).all()
            assert (kids[rows[1:]] == -1).all()
    # the leaves' chunk table covers exactly the reference's leaf rows
    leaves = jarrays["leaf_node_ids"]
    tree = plan.inner.tree
    start = np.zeros(tree.num_nodes, np.int64)
    count = np.zeros(tree.num_nodes, np.int64)
    start[leaves], count[leaves] = tree.start[leaves], tree.count[leaves]
    chunks, ptr = chunk_table(start, count)
    np.testing.assert_array_equal(a["mc_leaf_chunks"].numpy(), chunks)
    np.testing.assert_array_equal(a["mc_leaf_chunk_ptr"].numpy(), ptr)


def test_qhat_matches_reference_f64(x64, plans, cloud):
    plan, jarrays = plans
    _, q = cloud
    got = _qhat(plan.arrays, q, "hierarchical").numpy()
    jq = jnp.asarray(q)[jnp.asarray(jarrays["src_perm"])]
    want = np.asarray(jev.compute_qhat_hierarchical(
        jarrays, jq, degree=KW["degree"], backend="xla"))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0.0)


def test_qhat_equals_direct_precompute(plans, cloud):
    plan, _ = plans
    _, q = cloud
    hier = _qhat(plan.arrays, q, "hierarchical")
    direct = _qhat(plan.arrays, q, "direct")
    torch.testing.assert_close(hier, direct, rtol=1e-10, atol=0.0)


def test_execute_equals_direct_precompute_f64(plans, cloud):
    """The potentials with either q_hat (the executor past q_hat is the
    one `tests/test_torch_plan.py` holds against the reference)."""
    plan, _ = plans
    x, q = cloud
    cfg = dataclasses.replace(plan.config, precompute="direct")
    direct = TreecodeSolver(cfg, device="cpu").plan(x).execute(q)
    torch.testing.assert_close(plan.execute(q), direct, rtol=1e-10,
                               atol=0.0)


def test_capacity_padding_preserves_hierarchical(cloud):
    x, q = cloud
    x32, q32 = x[:1500].astype(np.float32), q[:1500].astype(np.float32)
    solver = TreecodeSolver(TreecodeConfig(**KW), device="cpu")
    plain = solver.plan(x32)
    padded = solver.plan(x32, capacities="auto")
    caps = padded.capacities
    assert caps.upward_rows and caps.num_leaf_chunks > 0
    assert len(caps.upward_rows) == caps.depth - 1
    np.testing.assert_allclose(plain.execute(q32).numpy(),
                               padded.execute(q32).numpy(),
                               rtol=1e-5, atol=1e-5)
    phi, _ = padded.potential_and_forces(q32)
    np.testing.assert_allclose(phi.numpy(), plain.execute(q32).numpy(),
                               rtol=1e-5, atol=1e-5)
    # a replan keeps the budget, the hierarchical rows included
    assert ev.plan_signature(padded.replan(x32 * 1.001).inner) == \
        ev.plan_signature(padded.inner)


def test_device_build_refuses_hierarchical_and_optimized_preset():
    with pytest.raises(ValueError, match="hierarchical"):
        TreecodeConfig(build_backend="device", precompute="hierarchical")
    with pytest.raises(ValueError, match="precompute"):
        TreecodeConfig(precompute="upward")
    assert bltc.OPTIMIZED.precompute == "hierarchical"
    assert (bltc.OPTIMIZED.theta, bltc.OPTIMIZED.degree,
            bltc.OPTIMIZED.leaf_size) == (0.8, 8, 4000)
    assert bltc.OPTIMIZED.build_backend == "host"

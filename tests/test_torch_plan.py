"""repro_torch host planner and executor vs the JAX reference.

The planner (tree, batches, MAC dual traversal, packing) is NumPy in
both packages and must agree BITWISE on the same points; the executor
run on the reference's own plan arrays (`arrays_from_numpy`) must agree
with `repro.core.eval.execute(backend="xla")`: f64 rtol 1e-10, f32
relative 2-norm <= 1e-5."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import eval as jeval
from repro.core import interaction as jint
from repro.core import potentials as jpot
from repro.core import space as jspace
from repro.core import tree as jtree
from repro_torch.core import eval as teval
from repro_torch.core import interaction as tint
from repro_torch.core import potentials as tpot
from repro_torch.core import space as tspace
from repro_torch.core import tree as ttree

L = 2.0
SPACES = {"free": (jspace.FREE, tspace.FREE),
          "periodic": (jspace.PeriodicBox((L, L, L)),
                       tspace.PeriodicBox((L, L, L)))}


def _points(seed, n, dtype=np.float64):
    r = np.random.default_rng(seed)
    return (r.uniform(0, L, (n, 3)).astype(dtype),
            r.uniform(-1, 1, n).astype(dtype))


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb or (va != va and vb != vb), f.name


@pytest.mark.parametrize("space", ["free", "periodic"])
@pytest.mark.parametrize("skin", [0.0, 0.08])
def test_planner_bitwise_equal(space, skin):
    js, ts = SPACES[space]
    x, _ = _points(1, 4000)
    y, _ = _points(2, 3500)
    xw, yw = js.wrap(x), js.wrap(y)
    tt, jt = ttree.build_tree(yw, 32), jtree.build_tree(yw, 32)
    _assert_fields_equal(tt, jt)
    tb, jb = ttree.build_batches(xw, 40), jtree.build_batches(xw, 40)
    _assert_fields_equal(tb, jb)
    for theta, degree in ((0.7, 2), (0.9, 1)):
        tl = tint.build_interaction_lists(tt, tb, theta, degree, ts,
                                          skin=skin)
        jl = jint.build_interaction_lists(jt, jb, theta, degree, js,
                                          skin=skin)
        _assert_fields_equal(tl, jl)
        assert (tl.approx >= 0).any()          # the approx lane is live
        if skin > 0:
            assert (tl.skin_direct >= 0).any()  # and the skin lists too
    np.testing.assert_array_equal(ttree.refit_tree(tt, yw * 1.01).lo,
                                  jtree.refit_tree(jt, yw * 1.01).lo)


@pytest.mark.parametrize("space", ["free", "periodic"])
def test_prepare_plan_arrays_equal(x64, space):
    js, ts = SPACES[space]
    x, _ = _points(3, 2000)
    kw = dict(theta=0.7, degree=3, leaf_size=64, batch_size=64, skin=0.05)
    tp = teval.prepare_plan(x, x, space=ts, device="cpu", **kw)
    jp = jeval.prepare_plan(x, x, space=js, **kw)
    # the port adds the modified charges' chunk table to the arrays
    assert set(tp.arrays) == set(jp.arrays) | set(teval.CHUNK_KEYS)
    for key, ja in jp.arrays.items():
        ta = tp.arrays[key]
        if isinstance(ja, tuple):
            assert len(ta) == len(ja)
            pairs = zip(ta, ja)
        else:
            pairs = [(ta, ja)]
        for t, j in pairs:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=key)
    for f in ("padding_waste", "mac_slack", "theta_slack", "fold_slack",
              "num_targets", "num_sources"):
        assert getattr(tp, f) == getattr(jp, f), f


CASES = [  # (space, skin, kernel, params)
    ("free", 0.0, "coulomb", ()),
    ("free", 0.05, "yukawa", (0.7,)),
    ("periodic", 0.0, "yukawa", (0.5,)),
    ("periodic", 0.05, "coulomb", ()),
]


@pytest.mark.parametrize("space,skin,kernel,params", CASES)
def test_execute_matches_reference_f64(x64, space, skin, kernel, params):
    js, ts = SPACES[space]
    x, q = _points(4, 1500)
    jp = jeval.prepare_plan(x, x, theta=0.7, degree=4, leaf_size=64,
                            batch_size=64, space=js, skin=skin)
    kw = dict(zip(("kappa",), params))
    jk = jpot.get_kernel(kernel, **kw)
    tk = tpot.get_kernel(kernel, **kw)
    want = np.asarray(jeval.execute(
        jp.arrays, jnp.asarray(q), degree=4, kernel=jk, space=js,
        backend="xla", theta=0.7, skin=skin))
    arrays = teval.arrays_from_numpy(
        {k: (tuple(map(np.asarray, v)) if isinstance(v, tuple)
             else np.asarray(v)) for k, v in jp.arrays.items()},
        device="cpu", dtype=torch.float64)
    got = teval._execute_impl(arrays, torch.as_tensor(q), degree=4,
                              kernel=tk, space=ts, theta=0.7, skin=skin)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("space,kahan,approx_r2", [
    ("free", False, "diff"), ("periodic", False, "diff"),
    ("free", True, "matmul"), ("periodic", True, "matmul")])
def test_execute_matches_reference_f32(space, kahan, approx_r2):
    js, ts = SPACES[space]
    x, q = _points(5, 1500, np.float32)
    jp = jeval.prepare_plan(x, x, theta=0.7, degree=4, leaf_size=64,
                            batch_size=64, space=js)
    want = np.asarray(jeval.execute(
        jp.arrays, jnp.asarray(q), degree=4, kernel=jpot.coulomb(),
        space=js, backend="xla", kahan=kahan, approx_r2=approx_r2))
    arrays = teval.arrays_from_numpy(
        {k: (tuple(map(np.asarray, v)) if isinstance(v, tuple)
             else np.asarray(v)) for k, v in jp.arrays.items()},
        device="cpu", dtype=torch.float32)
    got = teval._execute_impl(arrays, torch.as_tensor(q), degree=4,
                              kernel=tpot.coulomb(), space=ts, kahan=kahan,
                              approx_r2=approx_r2).numpy()
    assert got.dtype == np.float32
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5

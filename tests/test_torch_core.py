"""repro_torch numeric core vs the JAX reference: space, potentials, cheby.

Inputs are made with numpy from a seed and handed to both packages; the
comparisons are elementwise at float64 (the `x64` fixture on the JAX
side, torch.float64 on the port's)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import cheby as jcheby
from repro.core import potentials as jpot
from repro.core import space as jspace
from repro_torch.core import cheby as tcheby
from repro_torch.core import potentials as tpot
from repro_torch.core import space as tspace


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else a)


BOXES = [((1.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
         ((0.5, 1.0, 2.5), (-1.0, 0.5, 0.0))]


@pytest.mark.parametrize("lengths,origin", BOXES)
def test_periodic_box_matches_reference(x64, lengths, origin):
    rng = np.random.default_rng(3)
    jb = jspace.PeriodicBox(lengths, origin=origin)
    tb = tspace.PeriodicBox(lengths, origin=origin)
    x = rng.uniform(-25, 25, (256, 3))
    y = rng.uniform(-25, 25, (256, 3))
    # exact half-box displacements: round half to even on both sides
    half = np.asarray(lengths) * np.array([0.5, 1.5, -2.5])
    d = np.concatenate([x - y, half[None]])
    np.testing.assert_array_equal(_np(tb.min_image(_t(d))),
                                  np.asarray(jb.min_image(jnp.asarray(d))))
    np.testing.assert_array_equal(_np(tb.wrap(_t(x))),
                                  np.asarray(jb.wrap(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _np(tb.displacement(_t(x), _t(y))),
        np.asarray(jb.displacement(jnp.asarray(x), jnp.asarray(y))))
    spread = rng.uniform(0, 0.3, (256, 3))
    np.testing.assert_array_equal(
        _np(tb.fold_margin(_t(x - y), _t(spread))),
        np.asarray(jb.fold_margin(jnp.asarray(x - y), jnp.asarray(spread))))
    # the host (numpy) branch is the reference's numpy branch, bitwise
    np.testing.assert_array_equal(tb.min_image(d), jb.min_image(d))
    np.testing.assert_array_equal(tb.fold_margin(x - y, spread),
                                  jb.fold_margin(x - y, spread))
    # properties: |d| <= L/2 per coordinate, wrap lands in the cell
    L = np.asarray(tb.lengths)
    assert (np.abs(_np(tb.displacement(_t(x), _t(y)))) <= L / 2 + 1e-12).all()
    w = _np(tb.wrap(_t(x)))
    o = np.asarray(tb.origin)
    assert (w >= o - 1e-12).all() and (w < o + L + 1e-9).all()
    np.testing.assert_allclose(_np(tb.wrap(_t(w))), w, atol=1e-12)


def test_space_validation_and_free_space():
    with pytest.raises(ValueError, match="positive"):
        tspace.PeriodicBox((1.0, -1.0, 1.0))
    with pytest.raises(ValueError, match="origin"):
        tspace.PeriodicBox((1.0, 1.0, 1.0), origin=(0.0,))
    assert tspace.PeriodicBox(2.0).lengths == (2.0, 2.0, 2.0)
    assert tspace.resolve_space(None) == tspace.FreeSpace()
    with pytest.raises(TypeError, match="space"):
        tspace.resolve_space(object())
    x = torch.randn(4, 3, dtype=torch.float64)
    fs = tspace.FreeSpace()
    assert fs.wrap(x) is x and fs.min_image(x) is x
    assert fs.fold_margin(x, 1.0) == np.inf and not fs.periodic


@pytest.mark.parametrize("name,params", [("coulomb", ()), ("yukawa", (0.5,)),
                                         ("yukawa", (1.7,))])
def test_kernels_match_reference(x64, name, params):
    rng = np.random.default_rng(5)
    r2 = np.concatenate([[0.0, 1e-12, 1.0], rng.uniform(0, 9, 200)])
    jk = jpot.get_kernel(name, **dict(zip(("kappa",), params)))
    tk = tpot.get_kernel(name, **dict(zip(("kappa",), params)))
    got = _np(tk(_t(r2)))
    want = np.asarray(jk(jnp.asarray(r2)))
    assert got[0] == 0.0                       # the r2 > 0 mask
    np.testing.assert_allclose(got, want, rtol=1e-15)
    x = rng.uniform(-1, 1, (2, 7, 3))
    y = rng.uniform(-1, 1, (2, 9, 3))
    y[0, 0] = x[0, 0]                          # coincident pair
    box_t = tspace.PeriodicBox((1.5, 1.5, 1.5))
    box_j = jspace.PeriodicBox((1.5, 1.5, 1.5))
    for ts, js in ((tspace.FREE, jspace.FREE), (box_t, box_j)):
        np.testing.assert_allclose(
            _np(tk.pairwise(_t(x), _t(y), None, ts)),
            np.asarray(jk.pairwise(jnp.asarray(x), jnp.asarray(y), None, js)),
            rtol=1e-14)
    np.testing.assert_allclose(
        _np(tk.pairwise_matmul(_t(x), _t(y + 4.0))),
        np.asarray(jk.pairwise_matmul(jnp.asarray(x), jnp.asarray(y + 4.0))),
        rtol=1e-13)


def test_kernel_params_registry_and_packing():
    yk = tpot.yukawa(0.5)
    assert yk.normalize_params({"kappa": 0.9}) == (0.9,)
    assert yk.with_params({"kappa": 0.9}).params == (0.9,)
    assert yk.stripped().params == () and yk.stripped() == \
        tpot.yukawa(0.1).stripped()
    with pytest.raises(ValueError, match="no parameter"):
        yk.normalize_params({"sigma": 1.0})
    with pytest.raises(KeyError, match="unknown kernel"):
        tpot.get_kernel("nope")
    assert tpot.builtin_id(tpot.coulomb()) == 0
    assert tpot.builtin_id(yk) == 1
    user = tpot.Kernel("soft", lambda r2, p: 1.0 / torch.sqrt(r2 + 1.0))
    assert tpot.builtin_id(user) is None
    kappa = torch.tensor(0.7, dtype=torch.float64)
    vec = tpot.pack_params((kappa,), dtype=torch.float64, device="cpu")
    assert vec.shape == (1,) and float(vec[0]) == 0.7
    empty = tpot.pack_params((), dtype=torch.float32, device="cpu")
    assert empty.shape == (1,) and float(empty[0]) == 0.0
    # tensor params flow through of_r2 like the float defaults
    r2 = torch.tensor([0.0, 1.0, 4.0], dtype=torch.float64)
    np.testing.assert_array_equal(_np(yk(r2, (kappa,))),
                                  _np(tpot.yukawa(0.7)(r2)))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 14])
def test_cheby_points_weights_and_grid_bitwise(x64, n):
    np.testing.assert_array_equal(
        _np(tcheby.cheb_points_1d(n, torch.float64)),
        np.asarray(jcheby.cheb_points_1d(n, jnp.float64)))
    np.testing.assert_array_equal(
        _np(tcheby.bary_weights_1d(n, torch.float32)),
        np.asarray(jcheby.bary_weights_1d(n, jnp.float32)))
    rng = np.random.default_rng(n)
    lo = rng.uniform(-2, 0, (4, 3))
    hi = lo + rng.uniform(0.1, 2, (4, 3))
    np.testing.assert_array_equal(
        _np(tcheby.cluster_grid(_t(lo), _t(hi), n)),
        np.asarray(jcheby.cluster_grid(jnp.asarray(lo), jnp.asarray(hi), n)))


def test_cluster_grid_ordering():
    lo = torch.tensor([0.0, 10.0, 100.0])
    hi = torch.tensor([1.0, 11.0, 101.0])
    g = _np(tcheby.cluster_grid(lo, hi, 1))
    assert g.shape == (8, 3)
    assert g[0, 0] == g[1, 0] and g[0, 1] == g[1, 1] and g[0, 2] != g[1, 2]
    assert g[:, 0].min() == 0.0 and g[:, 0].max() == 1.0
    assert g[:, 2].min() == 100.0 and g[:, 2].max() == 101.0


@pytest.mark.parametrize("tol", [0.0, 1e-9])
def test_bary_terms_match_reference(x64, tol):
    rng = np.random.default_rng(9)
    s = np.asarray(jcheby.cheb_points_1d(6, jnp.float64))
    w = np.asarray(jcheby.bary_weights_1d(6, jnp.float64))
    y = np.concatenate([rng.uniform(-1, 1, 50), s, s + 1e-12])  # hits
    tt, td = tcheby.bary_terms(_t(y), _t(s), _t(w), tol=tol)
    jt, jd = jcheby.bary_terms(jnp.asarray(y), jnp.asarray(s),
                               jnp.asarray(w), tol=tol)
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=1e-15)
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-13)
    rows = _np(tcheby.lagrange_rows(_t(s), _t(s), _t(w)))
    np.testing.assert_array_equal(rows, np.eye(7))    # exact hits: one-hot


def test_interpolation_exact_for_polynomials():
    rng = np.random.default_rng(0)
    for degree in (1, 4, 10):
        f = np.polynomial.polynomial.Polynomial(rng.uniform(-1, 1, degree + 1))
        s = _np(tcheby.cheb_points_1d(degree, torch.float64))
        y = rng.uniform(-1, 1, 32)
        got = tcheby.interp_1d(_t(f(s)), _t(y), degree)
        np.testing.assert_allclose(_np(got), f(y), rtol=1e-10, atol=1e-10)

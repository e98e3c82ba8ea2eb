"""User kernels in the port against the JAX package, f64 on the CPU.

Twins of the reference's three user-kernel tests, on their inputs (made
from their seeds with numpy): the Gaussian and 1/(1 + r2) of
`tests/test_api.py` (`test_custom_kernel_object_round_trip`,
`test_registered_kernel_usable_by_name`) and the stretched Coulomb
r^-alpha with a named parameter of `tests/test_periodic.py`
(`test_registry_kernels_receive_params`). The reference runs
``backend="xla"`` under the `x64` fixture, the port ``device="cpu"`` in
float64; execute and forces are held at rtol 1e-10, and
`direct_oracle_f64` (the forces oracle of the card's phase 20) against the
reference's direct sum and its gradient. On the card the same kernels run
through their user libraries (`tests/test_torch_user_kernels_cuda.py`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.core.direct import direct_sum as jdirect_sum
from repro.core.potentials import Kernel as JKernel
from repro.core.potentials import register_kernel as jregister
from repro.core.potentials import registered_kernels as jregistered
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.direct import direct_oracle_f64
from repro_torch.core.potentials import Kernel, register_kernel

RTOL = 1e-10


def _particles(seed, n):
    r = np.random.default_rng(seed)
    return r.uniform(-1, 1, (n, 3)), r.uniform(-1, 1, n)


def _j_gauss(r2, params):
    (alpha,) = params
    return jnp.exp(-alpha * r2)


def _t_gauss(r2, params):
    (alpha,) = params
    return torch.exp(-alpha * r2)


def _j_inv_quad(r2, params):
    return 1.0 / (1.0 + r2)


def _t_inv_quad(r2, params):
    return 1.0 / (1.0 + r2)


def _j_stretched(r2, params):
    (alpha,) = params
    return jnp.reciprocal(jnp.sqrt(r2)) ** alpha


def _t_stretched(r2, params):
    (alpha,) = params
    return torch.reciprocal(torch.sqrt(r2)) ** alpha


def _register():
    """The reference's registrations, and the port's twins."""
    if "inv_quad_test" not in jregistered():
        jregister("inv_quad_test",
                  lambda: JKernel("inv_quad_test", _j_inv_quad))
    jregister("stretched_coulomb_test",
              lambda alpha=1.0: JKernel("stretched_coulomb_test",
                                        _j_stretched, (float(alpha),),
                                        ("alpha",)), overwrite=True)
    register_kernel("inv_quad_test",
                    lambda: Kernel("inv_quad_test", _t_inv_quad),
                    overwrite=True)
    register_kernel("stretched_coulomb_test",
                    lambda alpha=1.0: Kernel("stretched_coulomb_test",
                                             _t_stretched, (float(alpha),),
                                             ("alpha",)), overwrite=True)


#: (reference test, its inputs (seed, N), its config, the kernel on each
#: side: a Kernel object or a registered name with kernel_params)
CASES = {
    "gaussian_test": ((12, 1200), dict(theta=0.7, degree=6, leaf_size=64),
                      lambda: (JKernel("gaussian_test", _j_gauss, (2.0,)),
                               Kernel("gaussian_test", _t_gauss, (2.0,))),
                      {}),
    "inv_quad_test": ((13, 800), dict(degree=5, leaf_size=64),
                      lambda: ("inv_quad_test", "inv_quad_test"), {}),
    "stretched_coulomb_test": ((7, 600), dict(degree=6, leaf_size=64),
                               lambda: ("stretched_coulomb_test",
                                        "stretched_coulomb_test"),
                               {"alpha": 2.0}),
}


@functools.lru_cache(maxsize=None)
def _plans(name):
    """Both plans of a case, built once (under the x64 fixture)."""
    _register()
    (seed, n), kw, kernels, params = CASES[name]
    jk, tk = kernels()
    if name == "stretched_coulomb_test":      # the reference's rng draw
        rng = np.random.default_rng(seed)
        x, q = rng.uniform(-1, 1, (n, 3)), rng.uniform(-1, 1, n)
    else:
        x, q = _particles(seed, n)
    extra = {"kernel_params": params} if params else {}
    jplan = JSolver(JConfig(backend="xla", kernel=jk, **kw, **extra)).plan(
        x, nranks=1)
    tplan = TreecodeSolver(TreecodeConfig(kernel=tk, **kw, **extra),
                           device="cpu").plan(x)
    return jplan, tplan, x, q


@pytest.mark.parametrize("name", list(CASES))
def test_user_kernel_matches_reference(x64, name):
    """execute and potential_and_forces on the reference test's inputs:
    the port's plain path against the reference's XLA backend, f64 rtol
    1e-10 (the plan arrays are the reference's, the sums in another
    order)."""
    jplan, tplan, x, q = _plans(name)
    assert tplan.kernel.params == jplan.kernel.params
    phi = tplan.execute(q)
    assert phi.dtype == torch.float64
    np.testing.assert_allclose(phi.numpy(), np.asarray(jplan.execute(q)),
                               rtol=RTOL)
    tphi, tf = tplan.potential_and_forces(q)
    jphi, jf = jplan.potential_and_forces(q)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=RTOL)
    jf = np.asarray(jf)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=RTOL,
                               atol=RTOL * np.abs(jf).max())


@pytest.mark.parametrize("name", list(CASES))
def test_user_kernel_oracle_matches_reference(x64, name):
    """`direct_oracle_f64` of a user kernel (torch.func for G and dG/dr2)
    against the reference's direct sum, and its forces against jax.grad
    of the reference's direct sum at the target (exact hits add 0)."""
    jplan, tplan, x, q = _plans(name)
    phi, force = direct_oracle_f64(x, q, kernel=tplan.kernel)
    jk = jplan.kernel
    xj, qj = jnp.asarray(x), jnp.asarray(q)
    want = np.asarray(jdirect_sum(xj, xj, qj, kernel=jk))
    np.testing.assert_allclose(phi, want, rtol=RTOL)
    sample = np.arange(0, x.shape[0], 37)

    def phi_at(t):
        return jdirect_sum(t[None], xj, qj, kernel=jk)[0]

    grad = np.asarray(jax.vmap(jax.grad(phi_at))(xj[sample]))
    want_f = -q[sample, None] * grad
    np.testing.assert_allclose(force[sample], want_f, rtol=RTOL,
                               atol=RTOL * np.abs(want_f).max())

"""Degrees past the paper's 1..14 in the port against the JAX package.

The port runs any interpolation degree, as the reference does; on the card
degrees from 15 on take the runtime-degree kernels
(`tests/test_torch_cuda.py::test_degree_above_14_runs_on_the_card` holds
them against their plain versions there). Here, on the CPU in float64,
the port's plain path at degrees 15 and 17 against the reference's XLA
backend on the same inputs: `execute`, `potential_and_forces` and the
charge cotangent of the differentiable executor (against `jax.vjp` of the
reference's), at rtol 1e-10 with an absolute floor of 1e-12 times the
largest |value| (signed charges: an entry can cancel towards 0); and at
degree 24 (n+1 = 25, where the card's kernels pad and cut their slabs
past n+1 = 24) `execute` and the charge cotangent. These pin the plain
versions the card holds its kernels to.

A cluster is approximated only when it holds more than (n+1)^3 particles,
so the sources are one blob of 6000 points (> 16^3 = 4096 and 18^3 = 5832;
at degree 24 16000 > 25^3 = 15625, in leaves of 4000 to keep the plain
lanes small)
and the targets 200 points inside it (the direct lane) and 200 in a
second blob 4 away, whose batches take the whole source blob through the
approximation lane (asserted, so the test cannot pass on direct sums
alone). Targets apart from the sources keep the direct lane, which no
degree changes, small. The forces take per-target weights."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as jev
from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro_torch.core import eval as ev
from repro_torch.core.api import TreecodeConfig, TreecodeSolver

RTOL, FLOOR = 1e-10, 1e-12
SOURCES, TARGETS = 6000, 200
#: (sources, leaf size) where (n+1)^3 passes SOURCES.
LARGER = {24: (16000, 4000)}
SETTINGS = dict(theta=0.7, leaf_size=1000, batch_size=TARGETS)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=FLOOR * np.abs(want).max(), err_msg=what)


def _points(degree):
    """(targets, sources, charges, target weights, cotangent): the sources
    (SOURCES, or LARGER's) uniform in a cube of side 0.5 at the
    origin, TARGETS targets in it and TARGETS in a like cube centred 4
    away in x; the rest uniform in [-1, 1]."""
    rng = np.random.default_rng(27)
    n = LARGER.get(degree, (SOURCES,))[0]
    src = rng.uniform(-0.25, 0.25, (n, 3))
    tgt = rng.uniform(-0.25, 0.25, (2 * TARGETS, 3))
    tgt[TARGETS:, 0] += 4.0
    return (tgt, src, rng.uniform(-1, 1, n),
            rng.uniform(-1, 1, 2 * TARGETS), rng.uniform(-1, 1, 2 * TARGETS))


@functools.lru_cache(maxsize=None)
def _plans(degree):
    """(port plan on the CPU, reference plan on XLA), built once (under the
    x64 fixture)."""
    tgt, src, _, _, _ = _points(degree)
    settings = dict(SETTINGS)
    if degree in LARGER:
        settings["leaf_size"] = LARGER[degree][1]
    port = TreecodeSolver(TreecodeConfig(degree=degree, **settings),
                          device="cpu").plan(tgt, src)
    ref = JSolver(JConfig(backend="xla", degree=degree, **settings)).plan(
        tgt, src, nranks=1)
    return port, ref


def _approximated(plan, degree):
    """Slots of the approximation lane, after checking that every node it
    names holds more than (n+1)^3 particles."""
    idx = plan.arrays["approx_idx"]
    used = idx[idx >= 0].long().unique()
    assert (plan.inner.tree.count[used.numpy()] > (degree + 1) ** 3).all()
    return used.numel()


@pytest.mark.parametrize("degree", [15, 17, 24])
def test_execute_matches_reference(x64, degree):
    port, ref = _plans(degree)
    assert _approximated(port, degree) > 0
    q = _points(degree)[2]
    phi = port.execute(q)
    assert phi.dtype == torch.float64
    _close(phi.numpy(), np.asarray(ref.execute(q)), f"degree {degree} phi")


@pytest.mark.parametrize("degree", [15, 17])
def test_forces_match_reference(x64, degree):
    port, ref = _plans(degree)
    assert _approximated(port, degree) > 0
    _, _, q, w, _ = _points(degree)
    phi, force = port.potential_and_forces(q, weights=w)
    jphi, jforce = ref.potential_and_forces(q, weights=w)
    _close(phi.numpy(), jphi, f"degree {degree} phi")
    _close(force.numpy(), jforce, f"degree {degree} forces")


@pytest.mark.parametrize("degree", [15, 17, 24])
def test_charge_cotangent_matches_reference(x64, degree):
    port, ref = _plans(degree)
    assert _approximated(port, degree) > 0
    _, _, q, _, u = _points(degree)
    qt = torch.as_tensor(q).requires_grad_(True)
    phi = ev.differentiable_execute(port.arrays, qt, port.kernel_params,
                                    **port.config.exec_opts(port.kernel))
    (qbar,) = torch.autograd.grad(phi, [qt], torch.as_tensor(u))
    jarrays = {k: (tuple(jnp.asarray(np.asarray(v)) for v in a)
                   if isinstance(a, tuple) else jnp.asarray(np.asarray(a)))
               for k, a in ref.inner.arrays.items()}
    opts = ref.config.exec_opts(ref.kernel)

    def f(c):
        return jev.differentiable_execute(jarrays, c, ref.kernel_params,
                                          **opts)

    # one program: the reference's pieces traced op by op compile for ~15 s
    both = jax.jit(lambda c, v: (f(c), jax.vjp(f, c)[1](v)[0]))
    jphi, jqbar = both(jnp.asarray(q), jnp.asarray(u))
    _close(phi.detach().numpy(), jphi, f"degree {degree} phi")
    _close(qbar.numpy(), jqbar, f"degree {degree} charge cotangent")

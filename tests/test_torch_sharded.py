"""Sharded plans: the port's `ShardedPlan` against `repro`'s on the same
inputs.

RCB is held bitwise to `repro.distributed.rcb`. The reference's sharded
plan needs P JAX devices, so one module-scoped fixture runs it once, in a
subprocess with P host devices (the parent's JAX keeps its one), over
four cases: two free-space Coulomb cases (P = 2, and P = 4 with uneven
slabs), a periodic Yukawa case with a Verlet skin and a device-built
case (P = 3). It writes each case's integer arrays, rank tables, budget,
stats keys, f64 phi and forces and f32 phi to an `.npz`, and the port's
plan (``nranks=P``, stacked on the CPU) is held to it:

- every stacked integer array, the rank tables and every common
  `ShardedCapacities` field equal;
- f64 phi and forces at rtol 1e-10 with an absolute floor of 1e-12 times
  the largest |value| (a sum of signed terms may cancel towards 0,
  where only the rounding of the large terms is left; the kernels sum in
  another order than XLA);
- f32 phi at relative 2-norm <= 1e-5.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.distributed import rcb as jrcb
from repro_torch.core import eval as ev
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.direct import direct_oracle_f64
from repro_torch.core.space import PeriodicBox
from repro_torch.distributed import rcb as trcb
from repro_torch.distributed.bltc import ShardedPlan
from repro_torch.distributed.exchange import StackedRanks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 2.0
BASE = dict(theta=0.7, degree=3, leaf_size=32)

# name: (P, N, config options beyond BASE, periodic)
CASES = {
    "free_p2": (2, 2048, {}, False),
    "uneven_p4": (4, 1999, {}, False),
    "periodic_yukawa_p4": (4, 1600, dict(kernel="yukawa", skin=0.05,
                                         kernel_params={"kappa": 1.0},
                                         theta=0.8, degree=2,
                                         leaf_size=16), True),
    "device_p3": (3, 1536, dict(build_backend="device"), False),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps OpenMP from spinning
    against the other test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name):
    p, n, _, periodic = CASES[name]
    r = np.random.default_rng(len(name) + n)
    lo, hi = (0.0, L) if periodic else (-1.0, 1.0)
    return r.uniform(lo, hi, (n, 3)), r.uniform(-1, 1, n)


def _config(name, **extra):
    _, _, opts, periodic = CASES[name]
    return TreecodeConfig(space=PeriodicBox((L, L, L)) if periodic else None,
                          **dict(BASE, **opts, **extra))


_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro.core.api import TreecodeConfig, TreecodeSolver
from repro.core.space import PeriodicBox
out = sys.argv[1]
cases = json.loads(sys.argv[2])
for name, (p, opts, periodic) in cases.items():
    data = np.load(f"{out}/{name}_in.npz")
    cfg = TreecodeConfig(space=PeriodicBox((2.0,) * 3) if periodic else None,
                         backend="xla", **opts)
    solver = TreecodeSolver(cfg)
    x, q = data["x"], data["q"]
    plan = solver.plan(x, nranks=p)
    phi64 = np.asarray(plan.execute(q))
    _, f64 = plan.potential_and_forces(q)
    plan32 = solver.plan(x.astype(np.float32), nranks=p)
    phi32 = np.asarray(plan32.execute(q.astype(np.float32)))
    ints = {f"int_{k}": np.asarray(v) for k, v in plan.arrays.items()
            if np.issubdtype(np.asarray(v).dtype, np.integer)}
    np.savez(f"{out}/{name}.npz", phi64=phi64, f64=np.asarray(f64),
             phi32=phi32, rank_gather=np.asarray(plan.rank_gather),
             input_pos=np.asarray(plan.input_pos),
             caps=json.dumps(dataclasses.asdict(plan.capacities)),
             stats=json.dumps(sorted(plan.stats())), **ints)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{case: the reference's arrays and results}, from one subprocess
    with four host devices."""
    out = tmp_path_factory.mktemp("sharded_ref")
    spec = {}
    for name, (p, _, opts, periodic) in CASES.items():
        x, q = _inputs(name)
        np.savez(out / f"{name}_in.npz", x=x, q=q)
        spec[name] = (p, dict(BASE, **opts), periodic)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
         json.dumps(spec)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {name: dict(np.load(out / f"{name}.npz")) for name in CASES}


@pytest.fixture(scope="module")
def plans():
    """{case: the port's f64 plan}, built once for the module."""
    out = {}
    for name, (p, *_rest) in CASES.items():
        x, _ = _inputs(name)
        out[name] = TreecodeSolver(_config(name), device="cpu").plan(
            x, nranks=p)
    return out


def _close_f64(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    floor = 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=floor,
                               err_msg=what)


def _rel2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n,p,periodic", [(2048, 4, False), (1999, 4, False),
                                          (1000, 3, False), (777, 2, True)])
def test_rcb_matches_reference(n, p, periodic):
    r = np.random.default_rng(n)
    x = r.uniform(0, L, (n, 3)) if periodic else r.normal(size=(n, 3))
    if periodic:   # slabs tile the wrapped cell: wrap as the plan does
        x = np.asarray(PeriodicBox((L, L, L)).wrap(x + 0.7 * L))
    got, want = trcb.rcb_partition(x, p), jrcb.rcb_partition(x, p)
    for f in ("perm", "rank_of", "starts", "lo", "hi"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.max_count() == want.max_count() and got.nranks == p
    with pytest.raises(ValueError, match="at least one particle"):
        trcb.rcb_partition(x[:p - 1], p)
    with pytest.raises(ValueError, match="nranks"):
        trcb.rcb_partition(x, 0)


@pytest.mark.parametrize("name", list(CASES))
def test_arrays_and_budget_match_reference(reference, plans, name):
    ref, plan = reference[name], plans[name]
    keys = sorted(k[4:] for k in ref if k.startswith("int_"))
    assert keys == sorted(k for k in plan.arrays
                          if not k.startswith("mc_")
                          and not plan.arrays[k].is_floating_point()
                          and plan.arrays[k].dtype != torch.bool)
    for k in keys:
        np.testing.assert_array_equal(plan.arrays[k].numpy(),
                                      ref[f"int_{k}"], err_msg=k)
    for k in ("remote_approx_idx", "remote_direct_idx", "halo_send_0"):
        assert (plan.arrays[k] >= 0).any(), k
    np.testing.assert_array_equal(plan.rank_gather.numpy(),
                                  ref["rank_gather"])
    np.testing.assert_array_equal(plan.input_pos.numpy(), ref["input_pos"])
    want = json.loads(str(ref["caps"]))
    got = dataclasses.asdict(plan.capacities)
    for k, v in want.items():
        if k == "rank":
            for f, rv in v.items():
                assert got["rank"][f] == (tuple(rv) if isinstance(rv, list)
                                          else rv), f
        else:
            assert got[k] == (tuple(v) if isinstance(v, list) else v), k
    # the port's own budgets: every rank's chunk table fits
    assert got["rank"]["num_chunks"] >= plan.arrays["mc_chunk_ptr"][
        :, -1].max()
    assert sorted(plan.stats()) == json.loads(str(ref["stats"]))


@pytest.mark.parametrize("name", list(CASES))
def test_phi_and_forces_match_reference_f64(reference, plans, name):
    ref, plan = reference[name], plans[name]
    _, q = _inputs(name)
    phi = plan.execute(q)
    assert phi.dtype == torch.float64 and phi.shape == q.shape
    _close_f64(phi.numpy(), ref["phi64"], "phi")
    fphi, F = plan.potential_and_forces(q)
    _close_f64(F.numpy(), ref["f64"], "forces")
    _close_f64(fphi.numpy(), ref["phi64"], "phi of the force sweep")


@pytest.mark.parametrize("name", list(CASES))
def test_phi_matches_reference_f32(reference, name):
    x, q = _inputs(name)
    p = CASES[name][0]
    plan = TreecodeSolver(_config(name), device="cpu").plan(
        x.astype(np.float32), nranks=p)
    phi = plan.execute(q.astype(np.float32))
    assert phi.dtype == torch.float32
    assert _rel2(phi.numpy(), reference[name]["phi32"]) <= 1e-5


def test_sharded_converges_to_direct_sum(plans):
    """The sharded treecode is a treecode: its error against the f64
    direct sum is that of degree 3 (5e-4 here), as the single-device
    plan's on the same points."""
    x, q = _inputs("uneven_p4")
    phi = plans["uneven_p4"].execute(q).numpy()
    want, _ = direct_oracle_f64(x, q, kernel=plans["uneven_p4"].kernel)
    single = TreecodeSolver(_config("uneven_p4"), device="cpu").plan(
        x).execute(q).numpy()
    assert _rel2(phi, want) < 2e-3
    assert _rel2(phi, want) < 3 * _rel2(single, want)


def _small(p=2, n=900, **extra):
    """A small free-space plan of its own (x, q, plan)."""
    r = np.random.default_rng(n)
    x, q = r.uniform(-1, 1, (n, 3)), r.uniform(-1, 1, n)
    cfg = TreecodeConfig(**dict(BASE, **extra))
    return x, q, TreecodeSolver(cfg, device="cpu").plan(x, nranks=p)


def test_replan_keeps_budget_and_grows_on_overflow():
    x, q, plan = _small(3, skin=0.02)
    moved = x + np.random.default_rng(3).normal(scale=1e-3, size=x.shape)
    again = plan.replan(moved)
    assert again.capacities == plan.capacities
    assert ev.plan_signature(again) == ev.plan_signature(plan)
    assert isinstance(again.ranks, StackedRanks) and again.nranks == 3
    # a budget that cannot hold the build grows geometrically
    small = dataclasses.replace(
        plan.capacities, remote_direct_width=8, halo_width=8,
        rank=dataclasses.replace(plan.capacities.rank, direct_width=8))
    grown = plan.replan(x, capacities=small)
    assert grown.capacities.remote_direct_width > 8
    assert grown.capacities.halo_width > 8
    assert grown.capacities.rank.direct_width > 8
    assert ev.plan_signature(grown) != ev.plan_signature(plan)
    np.testing.assert_allclose(grown.execute(q).numpy(),
                               plan.execute(q).numpy(), rtol=1e-12,
                               atol=1e-12 * plan.execute(q).abs().max())
    with pytest.raises(ValueError, match="nranks"):
        ShardedPlan.build(x, plan.config, 2, device="cpu",
                          capacities=plan.capacities)
    with pytest.raises(TypeError, match="ShardedCapacities"):
        plan.replan(x, capacities=plan.capacities.rank)
    with pytest.raises(ValueError, match="targets == sources"):
        plan.replan(x, x.copy())


def test_ignored_options_and_solver_strategy():
    """The sharded program passes none of precompute="hierarchical",
    kahan and approx_r2 (as the reference's): the results are bitwise
    those of the default options. `plan` picks the strategy as the
    reference does."""
    x, q, plan = _small()
    base = TreecodeSolver(TreecodeConfig(**BASE), device="cpu")
    phi, (fphi, F) = plan.execute(q), plan.potential_and_forces(q)
    _, _, other = _small(precompute="hierarchical", kahan=True,
                         approx_r2="matmul")
    assert torch.equal(other.execute(q), phi)
    ophi, oF = other.potential_and_forces(q)
    assert torch.equal(ophi, fphi) and torch.equal(oF, F)
    assert "upward_pairs" not in other.arrays
    # strategy: nranks=1 and the auto default (no process group) give a
    # single-device plan; errors as the reference's
    assert base.plan(x, nranks=1).nranks == 1 and base.plan(x).nranks == 1
    with pytest.raises(ValueError, match="not both"):
        base.plan(x, nranks=2, mesh=object())
    with pytest.raises(ValueError, match="nranks must be >= 1"):
        base.plan(x, nranks=0)
    with pytest.raises(ValueError, match="targets == sources"):
        base.plan(x, x.copy(), nranks=2)
    with pytest.raises(ValueError, match="at least one particle"):
        base.plan(x[:3], nranks=4)
    # forces default their weights to the charges
    _, Fw = plan.potential_and_forces(q, weights=2 * q)
    np.testing.assert_allclose(Fw.numpy(), 2 * F.numpy(), rtol=1e-15)

"""Ensemble serving on the port (`repro_torch.serve`), held against `repro`.

The same f64 numpy inputs go through `repro.serve` (``backend="xla"``) and
`repro_torch.serve` (``device="cpu"``, the kernels' plain versions with
their systems axis): `EnsemblePlan.execute` and `potential_and_forces`
at rtol 1e-10 (the atol floor is 1e-12 of the largest entry, for
mixed-sign sums that cancel), in free space, a periodic box with a
Verlet skin, Yukawa with per-system kappas and under the hierarchical
precompute; `EnsembleMD`
over 10 steps at rtol 1e-9; `ServeFrontend` per request at rtol 1e-10
with the same flushes, buckets and occupancy. Small sizes: degree 3,
leaf 16, N 100-300, W = 3 or 4."""
import dataclasses
import subprocess
import sys
import os

import numpy as np
import pytest
import torch

from repro.core.api import TreecodeConfig as JConfig
from repro.core.space import PeriodicBox as JBox
from repro.serve import EnsembleMD as JEnsembleMD
from repro.serve import EnsemblePlan as JEnsemblePlan
from repro.serve import ServeFrontend as JServeFrontend
from repro.serve import bucket_key as jbucket_key
from repro.serve import quantize_points as jquantize_points
from repro_torch.core import eval as ev
from repro_torch.core.api import TreecodeConfig
from repro_torch.core.space import PeriodicBox
from repro_torch.serve import (EnsembleMD, EnsemblePlan, ServeFrontend,
                               bucket_key, quantize_points)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(degree=3, leaf_size=16, theta=0.7)
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems(seed, sizes, lo=-1.0, hi=1.0):
    r = np.random.default_rng(seed)
    xs = [r.uniform(lo, hi, (n, 3)) for n in sizes]
    qs = [r.uniform(-1, 1, n) for n in sizes]
    return xs, qs


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = 1e-12 * max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


CASES = {
    "free": (dict(), dict(), None),
    "periodic_skin": (dict(space=PeriodicBox((2.0, 2.0, 2.0),
                                             origin=(-1.0, -1.0, -1.0)),
                           skin=0.05),
                      dict(space=JBox((2.0, 2.0, 2.0),
                                      origin=(-1.0, -1.0, -1.0)),
                           skin=0.05), None),
    "yukawa_kappas": (dict(kernel="yukawa"), dict(kernel="yukawa"),
                      [{"kappa": k} for k in (0.5, 1.2, 2.0)]),
    "hierarchical": (dict(precompute="hierarchical"),
                     dict(precompute="hierarchical"), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ensemble_matches_reference(case, x64):
    tkw, jkw, params = CASES[case]
    xs, qs = _systems(3, (120, 300, 200))
    jplan = JEnsemblePlan.build(
        JConfig(backend="xla", dtype="float64", **KW, **jkw), xs)
    plan = EnsemblePlan.build(TreecodeConfig(dtype="float64", **KW, **tkw),
                              xs, device="cpu")
    assert plan.capacities.num_targets == jplan.capacities.num_targets
    assert plan.capacities.num_batches == jplan.capacities.num_batches
    phi = plan.execute(qs, kernel_params=params)
    jphi = np.asarray(jplan.execute(qs, kernel_params=params))
    assert tuple(phi.shape) == jphi.shape == (3, plan.num_targets)
    for i, n in enumerate(plan.sizes):
        _close(plan.split(phi)[i], jphi[i, :n], f"{case} phi {i}")
        assert (phi[i, n:] == 0).all(), "padded target slots"
    phi2, F = plan.potential_and_forces(qs, kernel_params=params)
    jphi2, jF = (np.asarray(a) for a in jplan.potential_and_forces(
        qs, kernel_params=params))
    for i, n in enumerate(plan.sizes):
        _close(phi2[i, :n], jphi2[i, :n], f"{case} pf phi {i}")
        _close(F[i, :n], jF[i, :n], f"{case} forces {i}")
        assert (F[i, n:] == 0).all(), "padded force rows must be exactly 0"


def test_stacked_charges_dummy_slots_and_stats(x64):
    xs, qs = _systems(5, (150, 100))
    cfg = TreecodeConfig(dtype="float64", **KW)
    plan = EnsemblePlan.build(cfg, xs, ensemble_width=4, device="cpu")
    jplan = JEnsemblePlan.build(JConfig(backend="xla", dtype="float64",
                                        **KW), xs, ensemble_width=4)
    assert plan.occupancy == 0.5 and plan.signature() == plan.signature()
    assert set(plan.stats()) == set(jplan.stats())
    # a pre-stacked slab gives what the list gives; dummy slots give 0
    slab = plan._charges(qs)
    assert tuple(slab.shape) == (4, plan.num_sources)
    assert (slab[2:] == 0).all()
    phi = plan.execute(slab)
    assert torch.equal(phi, plan.execute(qs))
    assert (phi[2:] == 0).all()
    # each system against its own single-system plan
    for i, (x, q) in enumerate(zip(xs, qs)):
        single = EnsemblePlan.build(cfg, [x], device="cpu")
        _close(phi[i, :len(x)], single.split(single.execute([q]))[0],
               f"system {i} alone")


def test_capacity_growth_on_oversized_member(x64):
    xs, qs = _systems(7, (100, 120))
    cfg = TreecodeConfig(dtype="float64", **KW)
    plan = EnsemblePlan.build(cfg, xs, device="cpu")
    big, qbig = _systems(8, (300,))
    grown = plan.replan([xs[0], big[0]])
    jplan = JEnsemblePlan.build(JConfig(backend="xla", dtype="float64",
                                        **KW), xs)
    jgrown = jplan.replan([xs[0], big[0]])
    assert grown.capacities != plan.capacities
    assert grown.num_targets >= 300 and grown.ensemble_width == 2
    for f in ("num_targets", "num_sources", "num_batches", "batch_width",
              "num_leaves", "leaf_width", "num_nodes", "approx_width",
              "direct_width", "depth", "bucket_rows", "bucket_widths"):
        assert getattr(grown.capacities, f) == getattr(jgrown.capacities,
                                                       f), f
    # re-submitting the original systems keeps the grown budget
    assert grown.replan(xs).capacities == grown.capacities
    phi = grown.execute([qs[0], qbig[0]])
    jphi = np.asarray(jgrown.execute([qs[0], qbig[0]]))
    for i, n in enumerate(grown.sizes):
        _close(phi[i, :n], jphi[i, :n], f"grown {i}")


def test_ensemble_md_matches_reference(x64):
    sizes = (100, 140, 120)
    xs, _ = _systems(9, sizes, lo=-0.5, hi=0.5)
    r = np.random.default_rng(10)
    qs = [np.where(r.random(n) < 0.5, -1.0, 1.0) for n in sizes]
    vs = [r.normal(0, 0.1, (n, 3)) for n in sizes]
    jplan = JEnsemblePlan.build(JConfig(backend="xla", dtype="float64",
                                        **KW), xs)
    plan = EnsemblePlan.build(TreecodeConfig(dtype="float64", **KW), xs,
                              device="cpu")
    jmd = JEnsembleMD(jplan, qs, dt=1e-4, velocities=vs).run(10)
    md = EnsembleMD(plan, qs, dt=1e-4, velocities=vs).run(10)
    assert md.steps == jmd.steps == 10
    for i, n in enumerate(sizes):
        _close(md.split_positions()[i], np.asarray(jmd.split_positions()[i]),
               f"positions {i}", rtol=1e-9)
        _close(md.split_velocities()[i],
               np.asarray(jmd.split_velocities()[i]), f"velocities {i}",
               rtol=1e-9)
        pad = md.state.x[i, n:]
        assert (pad == 0).all(), "padded rows stay at rest"


def test_ensemble_md_langevin_draws_each_replica_from_its_seed():
    """Langevin on the stacked state: replica i is the one-system ensemble
    of the same budget seeded ``seed + i`` (its own generator, drawn at
    the same shape)."""
    sizes = (100, 140, 120)
    xs, _ = _systems(11, sizes, lo=-0.5, hi=0.5)
    r = np.random.default_rng(12)
    qs = [np.where(r.random(n) < 0.5, -1.0, 1.0) for n in sizes]
    cfg = TreecodeConfig(dtype="float64", **KW)
    opts = dict(dt=1e-4, integrator="langevin",
                integrator_params=dict(friction=2.0, temperature=0.3))
    plan = EnsemblePlan.build(cfg, xs, device="cpu")
    md = EnsembleMD(plan, qs, seed=5, **opts).run(5)
    for i in range(len(sizes)):
        one = EnsemblePlan.build(cfg, [xs[i]], capacities=plan.capacities,
                                 device="cpu")
        solo = EnsembleMD(one, [qs[i]], seed=5 + i, **opts).run(5)
        _close(md.state.x[i], solo.state.x[0], f"positions {i}", rtol=1e-12)
        _close(md.state.v[i], solo.state.v[0], f"velocities {i}", rtol=1e-12)
    assert not torch.allclose(md.state.v[0, :100], md.state.v[1, :100])


def _drive(fe, reqs):
    return [fe.submit(x, q, kernel_params=p, forces=f)
            for x, q, p, f in reqs]


def test_frontend_matches_reference(x64):
    sizes = (90, 120, 200, 100, 250, 70, 130)
    xs, qs = _systems(12, sizes)
    kappas = (0.5, 1.0, 2.0)
    reqs = [(x, q, {"kappa": kappas[i % 3]}, i % 3 == 0)
            for i, (x, q) in enumerate(zip(xs, qs))]
    fe = ServeFrontend(TreecodeConfig(kernel="yukawa", dtype="float64",
                                      **KW), max_batch=3, device="cpu")
    jfe = JServeFrontend(JConfig(kernel="yukawa", backend="xla",
                                 dtype="float64", **KW), max_batch=3)
    futs, jfuts = _drive(fe, reqs), _drive(jfe, reqs)
    fe.flush()
    jfe.flush()
    for i, (f, jf) in enumerate(zip(futs, jfuts)):
        got, want = f.result(), jf.result()
        if f.want_forces:
            _close(got[0], want[0], f"request {i} phi")
            _close(got[1], want[1], f"request {i} forces")
        else:
            _close(got, want, f"request {i} phi")
    s, js = fe.stats(), jfe.stats()
    assert set(s) == set(js)
    for k in ("requests", "flushes", "num_buckets", "occupancy_mean",
              "queue_depth", "capacity_growths"):
        assert s[k] == js[k], k
    assert [(b["requests"], b["flushes"]) for b in s["buckets"].values()] \
        == [(b["requests"], b["flushes"]) for b in js["buckets"].values()]
    assert s["compiles"] == fe.compiles and s["retraces"] == 0


def test_frontend_deadline_result_mixed_and_warm_resubmission():
    now = [0.0]
    fe = ServeFrontend(TreecodeConfig(**KW), max_batch=4,
                       flush_deadline=1.0, clock=lambda: now[0],
                       device="cpu")
    xs, qs = _systems(14, (100, 110, 120))

    def round_trip():
        f0 = fe.submit(xs[0], qs[0])
        f1 = fe.submit(xs[1], qs[1], forces=True)      # a mixed batch
        assert fe.poll() == 0 and not f0.done() and fe.queue_depth() == 2
        now[0] += 1.5
        assert fe.poll() == 1 and f0.done() and f1.done()
        phi1, F1 = f1.result()
        assert phi1.shape == (110,) and F1.shape == (110, 3)
        assert f0.result().shape == (100,)
        # result() flushes its own bucket (a forces flush again, so a
        # budget grown here keeps the executor kind of both flushes warm)
        f2 = fe.submit(xs[2], qs[2], forces=True)
        assert not f2.done()
        assert f2.result()[0].shape == (120,) and fe.queue_depth() == 0
        return f0.result()

    phi0 = round_trip()
    s = fe.stats()
    assert s["flushes"] == 2 and s["occupancy_mean"] == (2 / 4 + 1 / 4) / 2
    assert s["compiles"] >= 1 and s["retraces"] == 0
    # a warm resubmission of the same requests: no compile, no retrace, no
    # capacity growth, the same results
    before = dict(s)
    assert torch.equal(round_trip(), phi0)
    s = fe.stats()
    assert s["compiles"] == before["compiles"] and s["retraces"] == 0
    assert s["capacity_growths"] == before["capacity_growths"]
    assert s["flushes"] == 4 and s["latency_p99"] >= s["latency_p50"] >= 0


def test_bucketing_equals_reference():
    for n in (1, 63, 64, 65, 700, 900, 1024, 1025, 50_000, 100_000):
        assert quantize_points(n) == jquantize_points(n)
        assert quantize_points(n, floor=16) == jquantize_points(n, floor=16)
    a = bucket_key(TreecodeConfig(kernel="yukawa",
                                  kernel_params={"kappa": 0.3}), 700)
    b = bucket_key(TreecodeConfig(kernel="yukawa",
                                  kernel_params={"kappa": 2.0}), 900)
    c = bucket_key(TreecodeConfig(kernel="yukawa", degree=5), 900)
    ja = jbucket_key(JConfig(kernel="yukawa", kernel_params={"kappa": 0.3}),
                     700)
    assert a == b and a != c and a[1] == ja[1] == 1024
    assert a[0] == dataclasses.replace(a[0], kernel_params=())


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)


def test_launch_serve_on_the_cpu_and_removed_flags():
    p = _launch("--device", "cpu", "--requests", "6", "--sizes", "80,100",
                "--max-batch", "3", "--degree", "3", "--leaf-size", "16",
                "--forces")
    assert p.returncode == 0, p.stderr[-2000:]
    assert "served 6 requests" in p.stdout and "retraces=0" in p.stdout
    p = _launch("--arch", "gpt")
    assert p.returncode != 0 and "LM-serving skeleton" in p.stderr
    # capacities reach the executors point-budgeted
    assert ev.Capacities.for_need(dict(
        num_batches=2, batch_width=8, num_leaves=2, leaf_width=8,
        num_nodes=3, approx_width=1, direct_width=2, depth=2,
        bucket_rows=(1, 2), bucket_widths=(16, 8), num_chunks=3,
        num_targets=12, num_sources=12), headroom=1.0,
        base=1).points_budgeted

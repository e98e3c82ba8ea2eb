"""repro_torch public API vs the JAX reference solver and the f64 oracle.

`TreecodeSolver(...).plan(x).execute(q)` with ``device="cpu"`` (the plain
PyTorch path) against `repro`'s solver on the same points and against
`direct_oracle_f64`, for Coulomb and Yukawa in free and periodic space;
plus the config validation, the options this slice does not port, and
the CUDA-by-default device rule."""
import numpy as np
import pytest
import torch

from repro.core.api import TreecodeConfig as JConfig
from repro.core.api import TreecodeSolver as JSolver
from repro.core.space import PeriodicBox as JBox
from repro_torch.configs import bltc
from repro_torch.core.api import TreecodeConfig, TreecodeSolver
from repro_torch.core.direct import (direct_oracle_f64, direct_sum,
                                     direct_sum_kernel)
from repro_torch.core.potentials import Kernel, coulomb, yukawa
from repro_torch.core.space import PeriodicBox

L = 2.0


def _rel2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _particles(seed, n, dtype=np.float64):
    r = np.random.default_rng(seed)
    return (r.uniform(0, L, (n, 3)).astype(dtype),
            r.uniform(-1, 1, n).astype(dtype))


# (theta, degree, leaf_size, oracle bar): the periodic box needs small
# clusters for fold-free approximations to exist at this N
SETTINGS = {"free": (0.7, 5, 100, 1e-4), "periodic": (0.8, 2, 24, 1e-2)}


@pytest.mark.parametrize("space", ["free", "periodic"])
@pytest.mark.parametrize("kernel", ["coulomb", "yukawa"])
def test_solver_matches_reference_and_oracle(x64, space, kernel):
    x, q = _particles(0, 2000)
    kp = {"kernel_params": {"kappa": 0.8}} if kernel == "yukawa" else {}
    theta, degree, leaf, bar = SETTINGS[space]
    kw = dict(theta=theta, degree=degree, leaf_size=leaf, kernel=kernel,
              **kp)
    tspace = PeriodicBox((L, L, L)) if space == "periodic" else None
    jspace = JBox((L, L, L)) if space == "periodic" else None
    plan = TreecodeSolver(TreecodeConfig(space=tspace, skin=0.03, **kw),
                          device="cpu").plan(x)
    assert (plan.arrays["approx_idx"] >= 0).any()
    phi = plan.execute(q)
    assert phi.dtype == torch.float64 and phi.shape == (2000,)
    want = np.asarray(JSolver(JConfig(space=jspace, skin=0.03,
                                      backend="xla", **kw)
                              ).plan(x, nranks=1).execute(q))
    np.testing.assert_allclose(phi.numpy(), want, rtol=1e-10)
    oracle, _ = direct_oracle_f64(x, q, kernel=plan.kernel,
                                  space=plan.space)
    assert _rel2(phi.numpy(), oracle) < bar


def test_f32_solver_matches_reference():
    x, q = _particles(1, 1500, np.float32)
    kw = dict(theta=0.7, degree=4, leaf_size=64)
    phi = TreecodeSolver(TreecodeConfig(**kw), device="cpu").plan(
        x).execute(q)
    assert phi.dtype == torch.float32
    want = np.asarray(JSolver(JConfig(backend="xla", **kw)).plan(
        x, nranks=1).execute(q))
    assert _rel2(phi.numpy(), want) <= 1e-5


def test_kernel_params_per_call_and_replan(x64):
    x, q = _particles(2, 1200)
    solver = TreecodeSolver(TreecodeConfig(
        theta=0.7, degree=4, leaf_size=64, kernel="yukawa",
        kernel_params={"kappa": 0.5}), device="cpu")
    plan = solver.plan(x)
    base = plan.execute(q)
    kappa = torch.tensor(1.3, dtype=torch.float64)
    swept = plan.execute(q, kernel_params={"kappa": kappa})
    direct = TreecodeSolver(TreecodeConfig(
        theta=0.7, degree=4, leaf_size=64, kernel="yukawa",
        kernel_params={"kappa": 1.3}), device="cpu").plan(x).execute(q)
    np.testing.assert_allclose(swept.numpy(), direct.numpy(), rtol=1e-13)
    assert not torch.equal(base, swept)
    moved = x + 0.01
    again = plan.replan(moved).execute(q)
    np.testing.assert_allclose(
        again.numpy(), solver.plan(moved).execute(q).numpy(), rtol=1e-13)
    st = plan.stats()
    assert st["strategy"] == "single_device" and st["device"] == "cpu"
    assert st["num_targets"] == 1200 and 0 < st["occupancy"][
        "target_slot_occupancy"] <= 1
    assert set(st["build_phases"]) == {"tree_build", "interaction_lists",
                                       "pack"}


def test_disjoint_targets_sources_and_direct_sums(x64):
    x, _ = _particles(3, 700)
    y, q = _particles(4, 900)
    kern = coulomb()
    phi = TreecodeSolver(TreecodeConfig(theta=0.6, degree=6, leaf_size=64),
                         device="cpu")(x, y, q)
    ref = direct_sum(torch.as_tensor(x), torch.as_tensor(y),
                     torch.as_tensor(q), kernel=kern, source_chunk=128)
    assert _rel2(phi.numpy(), ref.numpy()) < 1e-5
    one = direct_sum_kernel(torch.as_tensor(x), torch.as_tensor(y),
                            torch.as_tensor(q), kernel=kern)
    np.testing.assert_allclose(one.numpy(), ref.numpy(), rtol=1e-12)
    box = PeriodicBox((L, L, L))
    pts = np.concatenate([x, y])
    qq = np.concatenate([np.ones(700), q])
    ref_p = direct_sum(torch.as_tensor(pts), torch.as_tensor(pts),
                       torch.as_tensor(qq), (0.9,), kernel=yukawa(),
                       space=box)
    oracle, _ = direct_oracle_f64(pts, qq, kernel=yukawa(), params=(0.9,),
                                  space=box)
    np.testing.assert_allclose(ref_p.numpy(), oracle, rtol=1e-12)


def test_user_kernel_runs_on_torch_backend(x64):
    soft = Kernel("soft", lambda r2, p: 1.0 / torch.sqrt(r2 + p[0]), (0.1,),
                  ("eps",))
    x, q = _particles(5, 800)
    cfg = TreecodeConfig(theta=0.7, degree=6, leaf_size=64, kernel=soft,
                         backend="torch")
    phi = TreecodeSolver(cfg, device="cpu").plan(x).execute(q)
    t = torch.as_tensor(x)
    ref = soft.pairwise(t, t) @ torch.as_tensor(q)
    assert _rel2(phi.numpy(), ref.numpy()) < 1e-5


def test_config_validation_and_unported_options():
    with pytest.raises(ValueError, match="theta"):
        TreecodeConfig(theta=1.5)
    with pytest.raises(ValueError, match="degree"):
        TreecodeConfig(degree=0)
    with pytest.raises(ValueError, match="backend"):
        TreecodeConfig(backend="xla")
    with pytest.raises(ValueError, match="skin"):
        TreecodeConfig(skin=-1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TreecodeConfig(precompute="hierarchical")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TreecodeConfig(build_backend="device")
    x, q = _particles(6, 300)
    solver = TreecodeSolver(TreecodeConfig(leaf_size=64), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solver.plan(x, nranks=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solver.plan(x, capacities="auto")
    plan = solver.plan(x)
    with pytest.raises(NotImplementedError, match="forces"):
        plan.potential_and_forces(q)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plan.replan(x, capacities="auto")
    cfg = TreecodeConfig(kernel="yukawa", kernel_params={"kappa": 0.3})
    assert cfg.make_kernel().params == (0.3,)
    assert cfg == TreecodeConfig(kernel="yukawa",
                                 kernel_params={"kappa": 0.3})


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TreecodeSolver(TreecodeConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TreecodeSolver(TreecodeConfig())
    soft = Kernel("soft", lambda r2, p: 1.0 / torch.sqrt(r2 + 1.0))
    if torch.cuda.is_available():
        with pytest.raises(NotImplementedError, match="torch"):
            TreecodeSolver(TreecodeConfig(kernel=soft))


def test_paper_presets():
    assert len(bltc.FIG4) == 3 * 14
    cfg = bltc.fig4(0.7, 8)
    assert (cfg.theta, cfg.degree, cfg.leaf_size) == (0.7, 8, 2000)
    assert cfg.resolved_batch_size() == 2000 and cfg.kernel == "coulomb"
    assert bltc.SCALING_YUKAWA.make_kernel().params == (0.5,)
    with pytest.raises(KeyError):
        bltc.fig4(0.6, 8)

"""The four example twins (`examples/*_torch.py`) on the CPU against the
reference's examples and functions at the same inputs.

- quickstart: phi and forces against `repro`'s plan at f64 (rtol 1e-10
  with a floor), and the twin's CLI on a 4-rank gloo group (the sharded
  plan over the group) against the reference's plan on 4 host devices
  (f32, relative 2-norm 1e-5);
- md_nbody: the printed energies of a few steps against the reference
  example's (free-space Coulomb; a periodic Yukawa box);
- figure4_sweep: the kappa distances (f64, rtol 1e-10) and a small
  degree/theta sweep's errors against `benchmarks/fig4.py:run`'s;
- train_lm: 4 steps resumed from the reference example's checkpoint end
  on its step-6 checkpoint (every leaf, relative 2-norm 1e-5).
"""
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _load(name, path=EXAMPLES):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(path, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _run(args, **env):
    p = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, timeout=600, cwd=ROOT, env=_env(**env))
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-3000:])
    return p.stdout


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_matches_the_reference_plan(x64):
    """The twin's run at f64 against the reference's plan of the same
    config on the same points: phi and forces at rtol 1e-10 (atol 1e-12
    of the largest entry)."""
    from repro.core.api import TreecodeConfig, TreecodeSolver
    qs = _load("quickstart_torch")
    n = 3000
    r = qs.run(n, "cpu", np.float64)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (n, 3))
    q = rng.uniform(-1, 1, n)
    plan = TreecodeSolver(TreecodeConfig(
        theta=0.8, degree=8, leaf_size=512, kernel="coulomb")).plan(x)
    want = np.asarray(plan.execute(q))
    _, want_f = plan.potential_and_forces(q)
    got = r["phi"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())
    want_f = np.asarray(want_f)
    np.testing.assert_allclose(r["forces"].numpy(), want_f, rtol=1e-10,
                               atol=1e-12 * np.abs(want_f).max())
    assert r["stats"]["strategy"] == "single_device"
    assert r["err"] < 1e-6 and r["phi"].dtype == torch.float64


QS_RANKS = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=4, rank=rank)
    sys.path.insert(0, "examples")
    import quickstart_torch as qs
    r = qs.main(["--device", "cpu", "--n", "1500"])
    if rank == 0:
        np.save(out, r["phi"].numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1], sys.argv[2]), nprocs=4)
"""

QS_REFERENCE = r"""
import sys
import numpy as np
from repro.core.api import TreecodeConfig, TreecodeSolver
n = 1500
rng = np.random.default_rng(0)
points = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
charges = rng.uniform(-1, 1, n).astype(np.float32)
plan = TreecodeSolver(TreecodeConfig(
    theta=0.8, degree=8, leaf_size=512, kernel="coulomb")).plan(points)
assert plan.stats()["strategy"] == "sharded" and plan.stats()["nranks"] == 4
np.save(sys.argv[1], np.asarray(plan.execute(charges)))
"""


def test_quickstart_on_four_gloo_ranks(tmp_path):
    """The twin's CLI on a 4-rank gloo group builds the sharded plan over
    the group (rank 0 prints once) and its phi holds the reference's
    plan on 4 host devices (f32, relative 2-norm 1e-5)."""
    (tmp_path / "ranks.py").write_text(QS_RANKS)
    (tmp_path / "ref.py").write_text(QS_REFERENCE)
    got, want = tmp_path / "got.npy", tmp_path / "want.npy"
    out = _run([str(tmp_path / "ranks.py"), str(tmp_path / "store"),
                str(got)])
    _run([str(tmp_path / "ref.py"), str(want)],
         XLA_FLAGS="--xla_force_host_platform_device_count=4")
    assert out.count("strategy = sharded (nranks = 4)") == 1, out
    assert out.count("relative 2-norm error") == 1
    err = float(re.search(r"Eq. 16\): (\S+)", out).group(1))
    assert err < 1e-5
    a, b = np.load(got), np.load(want)
    assert a.shape == b.shape == (1500,)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-5


# ---------------------------------------------------------------------------
# md_nbody
# ---------------------------------------------------------------------------

STEP = re.compile(r"^step\s+(\d+)\s+KE\s+(\S+)\s+PE\s+(\S+)\s+E\s+(\S+)\s+"
                  r"T\s+(\S+)", re.M)


@pytest.mark.parametrize("flags", [
    ["--n", "400", "--steps", "6"],
    ["--n", "343", "--steps", "10", "--box", "7", "--kernel", "yukawa"],
], ids=["free_coulomb", "periodic_yukawa"])
def test_md_nbody_energies_match_the_reference(flags, tmp_path, capsys):
    """The twin's printed KE, PE, E and T at every recorded step equal
    the reference example's to its printed digits (1e-6 absolute; the
    f32 trajectories agree to far less); checkpoints at the same steps,
    with the same leaves."""
    md = _load("md_nbody_torch")
    ck_ref, ck_port = str(tmp_path / "ref"), str(tmp_path / "port")
    every = ["--checkpoint-every", "3"]
    ref = _run(["examples/md_nbody.py", *flags, "--checkpoint", ck_ref,
                *every])
    sim = md.main([*flags, "--device", "cpu", "--checkpoint", ck_port,
                   *every])
    out = capsys.readouterr().out
    want = [tuple(map(float, m)) for m in STEP.findall(ref)]
    got = [tuple(map(float, m)) for m in STEP.findall(out)]
    assert len(got) == len(want) >= 3
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1.01e-6)
    assert "retraces 0" in out and "energy drift" in out
    assert sim.stats()["retraces"] == 0
    assert sorted(os.listdir(ck_port)) == sorted(os.listdir(ck_ref))
    step = sorted(os.listdir(ck_ref))[-1]
    with open(os.path.join(ck_ref, step, "manifest.json")) as f:
        ref_keys = set(json.load(f)["leaves"])
    with open(os.path.join(ck_port, step, "manifest.json")) as f:
        assert set(json.load(f)["leaves"]) == ref_keys


# ---------------------------------------------------------------------------
# figure4_sweep
# ---------------------------------------------------------------------------


def test_kappa_sweep_matches_the_reference(x64):
    """One stacked launch for five kappas: the distances from the
    smallest kappa's phi at f64 rtol 1e-10, one first call."""
    fig = _load("figure4_sweep_torch")
    ref = _load("figure4_sweep")
    got, compiles = fig.kappa_sweep(n_particles=617, device="cpu")
    want, ref_compiles = ref.kappa_sweep(n_particles=617)
    assert compiles == ref_compiles == 1
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], rtol=1e-10,
                               atol=1e-14)


def test_kappa_only_cli_prints_the_references_lines():
    """The CLI in a process of its own (a second sweep of the same shapes
    in one process finds its stacked signature seen: no first call, as
    the reference's jit cache would hold it): the reference's lines."""
    out = _run(["examples/figure4_sweep_torch.py", "--kappa-only", "--n",
                "600", "--device", "cpu"]).splitlines()
    want = _run(["examples/figure4_sweep.py", "--kappa-only", "--n",
                 "600"]).splitlines()
    assert out[:2] == want[:2] == [
        "kappa sweep: 1 ensemble launch, 1 compile",
        "kappa,rel2_vs_smallest_kappa"]
    assert [line.split(",")[0] for line in out[2:]] == [
        line.split(",")[0] for line in want[2:]] == [
        "0.1", "0.3", "0.5", "0.7", "1.0"]
    np.testing.assert_allclose(
        [float(line.split(",")[1]) for line in out[2:]],
        [float(line.split(",")[1]) for line in want[2:]], rtol=2e-3)


def test_fig4_sweep_matches_the_reference_rows(x64, capsys):
    """A small degree/theta sweep: each row's error against the direct
    sum equals the reference's (`benchmarks/fig4.py:run`) to rtol 1e-6,
    and the paper's claims hold."""
    fig = _load("figure4_sweep_torch")
    bench = _load("fig4", os.path.join(ROOT, "benchmarks"))
    kw = dict(n_particles=3000, thetas=(0.5, 0.9), degrees=(1, 4))
    got = fig.fig4_rows(device="cpu", **kw)
    want = bench.run(**kw)
    capsys.readouterr()
    assert [r[:3] for r in got] == [r[:3] for r in want]
    np.testing.assert_allclose([r[4] for r in got], [r[4] for r in want],
                               rtol=1e-6, atol=1e-14)
    assert len(fig.check_paper_claims(got)) == 5


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------


def test_train_lm_resumes_the_reference_run(tmp_path, capsys):
    """The reference example trains 6 steps (checkpoints at 2, 4, 6); the
    twin resumes from a copy of its step_2 and trains to 6: its step_6
    holds the reference's in every leaf within 1e-5, and it prints the
    reference's last loss line."""
    lm = _load("train_lm_torch")
    small = ["--steps", "6", "--ckpt-every", "2", "--seq", "16", "--batch",
             "4", "--d-model", "64", "--layers", "2"]
    ref, port = tmp_path / "ref", tmp_path / "port"
    out_ref = _run(["examples/train_lm.py", *small, "--ckpt-dir", str(ref)])
    port.mkdir()
    shutil.copytree(ref / "step_2", port / "step_2")
    losses = lm.main([*small, "--ckpt-dir", str(port), "--resume",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and set(losses) == {5}
    # the step's loss and gnorm as printed (a "[straggler]" flag after them
    # depends on the host's timing)
    last = re.compile(r"^step    5  loss \S+  gnorm \S+", re.M)
    assert last.search(out).group(0) == last.search(out_ref).group(0)
    with open(ref / "step_6" / "manifest.json") as f:
        man = json.load(f)["leaves"]
    with open(port / "step_6" / "manifest.json") as f:
        mine = json.load(f)["leaves"]
    assert man.keys() == mine.keys() and len(man) > 30
    for key in man:
        a = np.load(port / "step_6" / mine[key]["file"]).astype(np.float64)
        b = np.load(ref / "step_6" / man[key]["file"]).astype(np.float64)
        assert a.shape == b.shape, key
        assert np.linalg.norm(a - b) <= 1e-5 * max(np.linalg.norm(b),
                                                   1e-30), key

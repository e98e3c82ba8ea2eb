"""The training launcher on a mesh of several ranks (gloo on the CPU).

- The reference's launcher on 4 forced host devices writes `step_2` and
  `step_4`; the port's, under torchrun on 4 gloo ranks (a (4, 1) mesh),
  resumes from a copy of the reference's `step_2` and writes its own
  `step_4`, which holds the reference's in every leaf (params and AdamW
  state) within a relative 2-norm of 1e-5.
- Through `launch.train.train` on a 2 x 2 mesh (the model axis sharded)
  the port ends 2 steps within 1e-5 a leaf of a one-device run from the
  same parameters, and its checkpoint restores on one device and on a
  (4, 1) mesh with equal tensors.
- NCCL with more ranks than cards is refused, naming --dist-backend gloo.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--smoke", "--steps", "4", "--seq", "16", "--batch", "4",
         "--ckpt-every", "2"]
REL = 1e-5


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _leaves(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        man = json.load(f)["leaves"]
    return {k: np.load(os.path.join(step_dir, v["file"])) for k, v in
            man.items()}


def _rel2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def reference_and_port(tmp_path_factory):
    """The reference's 4-device run and the port's 4-rank resume from its
    step_2: (reference dir, port dir, the port's stdout)."""
    d = tmp_path_factory.mktemp("ranks")
    ref, port = str(d / "ref"), str(d / "port")
    p = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *FLAGS, "--ckpt-dir",
         ref], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "{'data': 4, 'model': 1}" in p.stdout
    os.makedirs(port)
    shutil.copytree(os.path.join(ref, "step_2"), os.path.join(port, "step_2"))
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *FLAGS,
         "--device", "cpu", "--dist-backend", "gloo", "--ckpt-dir", port],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=_env())
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-3000:])
    return ref, port, p.stdout


def test_four_ranks_print_once_on_the_reference_mesh(reference_and_port):
    _, port, out = reference_and_port
    assert out.count("internlm2-1.8b-smoke:") == 1
    assert "mesh {'data': 4, 'model': 1} on cpu" in out
    assert out.count("resumed from step 2") == 1
    assert out.count("watchdog flags") == 1
    # rank 0 alone wrote; keep-last left both steps
    assert sorted(os.listdir(port)) == ["step_2", "step_4"]


def test_four_ranks_resume_the_reference_run(reference_and_port):
    """The port's 4-rank step_4, resumed from the reference's 4-device
    step_2, against the reference's step_4: every leaf within 1e-5."""
    ref, port, _ = reference_and_port
    want = _leaves(os.path.join(ref, "step_4"))
    got = _leaves(os.path.join(port, "step_4"))
    assert got.keys() == want.keys() and len(got) > 30
    errs = {k: _rel2(got[k], want[k]) for k in want}
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert max(errs.values()) <= REL, max(errs.items(), key=lambda e: e[1])
    assert int(got["opt::step"]) == int(want["opt::step"]) == 4


MESH = r"""
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=4, rank=rank)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.store import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.api import Model
    from repro_torch.models.config import RULE_SETS, make_shardings
    from repro_torch.models.layers import (decl_logical, decl_shapes,
                                           materialize, tree_leaves)
    from repro_torch.optim.optimizers import AdamW

    flags = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
             "--batch", "4", "--ckpt-every", "2"]
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    args = train.parser().parse_args(flags + ["--ckpt-dir", tmp + "/2x2"])
    got = train.train(args, mesh, "cpu")
    sharded = sum(any(p.is_shard() for p in t.placements[1:])
                  for t in tree_leaves(got))
    got = [t.full_tensor() for t in tree_leaves(got)]
    # the checkpoint on a (4, 1) mesh, placed by make_shardings
    model = Model(get_config("internlm2-1.8b", smoke=True))
    decls, opt = model.decls(), AdamW()
    p0 = materialize(decls, 0, device="cpu")
    s0 = opt.init(p0)
    wide = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    logical = decl_logical(decls)
    places = {"params": make_shardings(logical, decl_shapes(decls),
                                       RULE_SETS["tp"], wide),
              "opt": make_shardings(opt.state_logical(logical), s0,
                                    RULE_SETS["tp"], wide)}
    ck = Checkpointer(tmp + "/2x2")
    tree, step, _ = ck.restore({"params": p0, "opt": s0}, shardings=places,
                               mesh=wide)
    on_wide = [t.full_tensor() for t in tree_leaves(tree)]
    wide_placed = all(hasattr(t, "placements") for t in tree_leaves(tree))
    if rank == 0:
        one_args = train.parser().parse_args(flags + ["--ckpt-dir",
                                                      tmp + "/one"])
        one = train.train(one_args, MeshShape((1, 1), ("data", "model")),
                          "cpu")
        errs = [float((g - w).norm() / w.norm().clamp_min(1e-30))
                for g, w in zip(got, tree_leaves(one))]
        plain, _, _ = ck.restore({"params": p0, "opt": s0})
        same_one = all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(plain["params"]), got))
        same_wide = all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(plain), on_wide))
        with open(tmp + "/out.txt", "w") as f:
            f.write(f"{max(errs)!r} {len(errs)} {sharded} {step} "
                    f"{same_one} {same_wide} {wide_placed}")
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1], sys.argv[2]), nprocs=4)
"""


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    script = d / "mesh.py"
    script.write_text(MESH)
    # a file store for the rendezvous: no port to race other tests for
    p = subprocess.run([sys.executable, str(script), str(d / "store"),
                        str(d)], capture_output=True, text=True,
                       timeout=300, env=_env(), cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    err, leaves, sharded, step, same_one, same_wide, placed = \
        (d / "out.txt").read_text().split()
    return dict(err=float(err), leaves=int(leaves), sharded=int(sharded),
                step=int(step), same_one=same_one == "True",
                same_wide=same_wide == "True", placed=placed == "True",
                dirs=sorted(os.listdir(d / "2x2")))


def test_two_by_two_mesh_matches_one_device(two_by_two):
    """2 steps on a 2 x 2 mesh, model axis sharded, against one device
    from the same parameters: every parameter leaf within 1e-5."""
    assert two_by_two["leaves"] > 10 and two_by_two["sharded"] > 0
    assert two_by_two["err"] <= REL, two_by_two["err"]


def test_checkpoint_of_a_mesh_restores_elsewhere(two_by_two):
    """The 2 x 2 run's step_2 restores on one device and on a (4, 1) mesh
    (DTensors placed by `make_shardings`) with the 2 x 2 run's tensors."""
    assert two_by_two["step"] == 2 and two_by_two["dirs"] == ["step_2"]
    assert two_by_two["placed"]
    assert two_by_two["same_one"] and two_by_two["same_wide"]


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        launch_mesh.start_group("cuda", "nccl")
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        train.main(["--smoke", "--device", "cuda", "--dist-backend",
                    "nccl", "--steps", "1"])
    assert not torch.distributed.is_initialized()


def test_nccl_needs_cuda_and_one_process_starts_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        launch_mesh.start_group("cpu", "nccl")
    assert launch_mesh.start_group("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()

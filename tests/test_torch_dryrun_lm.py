"""The LM dry run (`repro_torch.launch.dryrun`) against the reference's
counts and shardings, at SMOKE size over a 2 x 2 fake mesh. The one-device
dry run and the gloo group's DTensor loss have files of their own
(`test_torch_dryrun_one_device.py`, `test_torch_dtensor_gloo.py`)."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import (get_config, optimizer_for,
                                          rule_set_for)
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import OpCounter
from repro_torch.models.api import Model, ShapeSpec
from repro_torch.models.config import RULE_SETS
from repro_torch.models.layers import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-1.3b")
SHAPES = {"train": ShapeSpec("train_64", 64, 4, "train"),
          "decode": ShapeSpec("decode_64", 64, 4, "decode")}
CELLS = [(a, k) for a in ARCHS for k in SHAPES]


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def reference_counts():
    """param_count and active_params of the reference's dry run, which sets
    XLA_FLAGS when it is imported: run in a subprocess."""
    code = ("import json\n"
            "from repro.configs.registry import get_config\n"
            "from repro.launch.dryrun import active_params\n"
            "from repro.models.api import Model\n"
            "from repro.models.layers import param_count\n"
            f"out = {{a: [param_count(Model(get_config(a, smoke=True))"
            f".decls()), active_params(Model(get_config(a, smoke=True)))]"
            f" for a in {ARCHS!r}}}\n"
            "print(json.dumps(out))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=_env(), cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def dry_runs():
    """Each cell's report and its arguments' local shard shapes over a
    2 x 2 fake mesh (the group torn down after)."""
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    with dryrun.fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for arch, kind in CELLS:
            model = Model(get_config(arch, smoke=True))
            _, args = dryrun.step_inputs(model, SHAPES[kind], mesh,
                                         RULE_SETS[rule_set_for(arch)],
                                         optimizer_for(arch))
            local = [tuple(dryrun.local(t).shape) for t in tree_leaves(args)]
            rep = dryrun.cell_report(arch, model, SHAPES[kind], mesh, "2x2")
            out[arch, kind] = rep, local
        rows = torch.empty((64, 96), device="meta")
        cols = torch.empty((96, 32), device="meta")
        from torch.distributed.tensor import Replicate, Shard
        a = dryrun.on_mesh(rows, (Shard(0), Replicate()), mesh)
        b = dryrun.on_mesh(cols, (Replicate(), Shard(1)), mesh)
        with OpCounter() as c:
            prod = a @ b
        out["matmul"] = c.totals, tuple(prod.placements)
    import torch.distributed as dist
    assert not dist.is_initialized()
    return out


def _ref_shard_shapes(arch, kind):
    """The reference's per-leaf shard shapes of params, optimizer state and
    inputs over a (2, 2) ("data", "model") mesh."""
    from jax.sharding import AbstractMesh
    from repro.configs.registry import get_config as rget
    from repro.models.api import Model as RModel
    from repro.models.api import ShapeSpec as RShape
    from repro.models.config import RULE_SETS as RRULES
    from repro.models.config import make_shardings
    from repro.models.layers import decl_logical, decl_shapes
    from repro.optim.optimizers import get_optimizer as rget_opt
    mesh = AbstractMesh((2, 2), ("data", "model"))
    model = RModel(rget(arch, smoke=True))
    rules = RRULES[rule_set_for(arch)]
    s = SHAPES[kind]
    shape = RShape(s.name, s.seq_len, s.global_batch, s.kind)
    p_shapes, p_logical = decl_shapes(model.decls()), decl_logical(
        model.decls())
    trees = [(p_shapes, p_logical)]
    if kind == "train":
        opt = rget_opt(optimizer_for(arch))
        trees.append((jax.eval_shape(opt.init, p_shapes),
                      opt.state_logical(p_logical)))
    trees.append((model.input_specs(shape), model.input_logical(shape)))
    out = []
    for shapes, logical in trees:
        shard = make_shardings(logical, shapes, rules, mesh)
        for sh, ns in zip(jax.tree.leaves(shapes), jax.tree.leaves(shard)):
            out.append((tuple(ns.shard_shape(sh.shape)),
                        np.dtype(sh.dtype).itemsize))
    return out


@pytest.mark.parametrize("arch,kind", CELLS)
def test_counts_equal_the_reference(arch, kind, dry_runs, reference_counts):
    rep, _ = dry_runs[arch, kind]
    n_params, n_active = reference_counts[arch]
    assert rep["status"] == "ok" and rep["chips"] == 4
    assert rep["params"] == n_params
    assert rep["active_params"] == n_active
    s = SHAPES[kind]
    tokens = s.global_batch * (s.seq_len if kind == "train" else 1)
    assert rep["tokens"] == tokens
    assert rep["model_flops"] == (6 if kind == "train" else 2) * \
        n_active * tokens


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_are_the_reference_shards(arch, kind, dry_runs):
    rep, local = dry_runs[arch, kind]
    want = _ref_shard_shapes(arch, kind)
    assert local == [shape for shape, _ in want]
    assert rep["per_device"]["argument_bytes"] == sum(
        int(np.prod(shape)) * size for shape, size in want)
    pd = rep["per_device"]
    assert pd["peak_hbm_est"] == pd["argument_bytes"] + pd["output_bytes"] \
        + pd["temp_bytes"] - pd["alias_bytes"]
    # params and moments are updated in place, and a KV cache; mamba2's
    # decode returns new conv and SSM states
    in_place = kind == "train" or arch != "mamba2-1.3b"
    assert (pd["alias_bytes"] > 0) == in_place
    assert rep["collectives"] and rep["collective_wire_bytes_per_device"] > 0
    assert 0 < rep["roofline"]["useful_flops_frac"] <= 1.0


def test_sharded_matmul_counts_a_quarter_per_device(dry_runs):
    totals, placements = dry_runs["matmul"]
    assert totals.matmul_flops == 2 * 64 * 96 * 32 / 4
    assert totals.collectives == {}
    assert [p.is_shard() for p in placements] == [True, True]

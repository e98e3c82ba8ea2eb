"""An LM's DTensor loss and gradient on a 2 x 2 gloo group (parameters
placed by `make_shardings`, activations by `ShardCtx.constrain`) against
one device's. No JAX."""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


GLOO = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=4, rank=rank)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import Model
    from repro_torch.models.config import (RULE_SETS, make_shardings,
                                           shard_ctx_for_mesh)
    from repro_torch.models.layers import (decl_logical, materialize,
                                           tree_leaves)
    from repro_torch.training.step import loss_and_grads
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model = Model(get_config("internlm2-1.8b", smoke=True))
    params = materialize(model.decls(), 0, device="cpu")
    place = make_shardings(decl_logical(model.decls()), params,
                           RULE_SETS["tp"], mesh)

    def dist_tree(t, pl):
        if isinstance(t, dict):
            return {k: dist_tree(v, pl[k]) for k, v in t.items()}
        return distribute_tensor(t, mesh, pl)

    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab, (4, 33)).astype(np.int32))
    tok_pl = make_shardings({"tokens": ("batch", "seq")}, {"tokens": tokens},
                            RULE_SETS["tp"], mesh)["tokens"]
    batch = {"tokens": distribute_tensor(tokens, mesh, tok_pl)}
    with implicit_replication():
        (loss, _), grads = loss_and_grads(model, dist_tree(params, place),
                                          batch, shard_ctx_for_mesh(mesh))
    got = float(loss.full_tensor())
    grads = [g.full_tensor() for g in tree_leaves(grads)]
    if rank == 0:
        (want, _), ref = loss_and_grads(model, params, {"tokens": tokens})
        errs = [float((g - r).norm() / r.norm()) for g, r in
                zip(grads, tree_leaves(ref))]
        with open(out, "w") as f:
            f.write(f"{got!r} {float(want)!r} {max(errs)!r} {len(errs)}")
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1], sys.argv[2]), nprocs=4)
"""


def test_dtensor_loss_on_a_gloo_group_equals_one_device(tmp_path):
    """internlm2 SMOKE `model.loss` on a 2 x 2 gloo group, parameters as
    DTensors placed by `make_shardings`, activations by `ShardCtx`: the
    one-device loss at f32 rtol 1e-5, and its gradient leaf by leaf
    (relative 2-norm 1e-5)."""
    script = tmp_path / "gloo_loss.py"
    script.write_text(GLOO)
    out = tmp_path / "loss.txt"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # a file store for the rendezvous: no port to race other tests for
    p = subprocess.run([sys.executable, str(script), str(tmp_path / "store"),
                        str(out)], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    got, want, grad_err, leaves = out.read_text().split()
    assert np.isfinite(float(want)) and int(leaves) > 10
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(grad_err) <= 1e-5, grad_err

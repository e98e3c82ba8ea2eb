#!/usr/bin/env python3
"""An LM's DTensor loss and gradient on a gloo group against one device.

    python3 tools/dtensor_grad_check.py ARCH [DATAxMODEL]   (default 2x2)

Spawns DATA x MODEL gloo processes on this host, places ARCH's SMOKE
parameters as DTensors by `make_shardings` (the arch's rule set) over a
("data", "model") `DeviceMesh`, its batch by the inputs' logical axes,
and runs `training.step.loss_and_grads` with `shard_ctx_for_mesh`; rank
0 prints the loss beside the one-device loss and the largest relative
2-norm error of a gradient leaf. Needs no card (f32 on the CPU).
"""
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def batch_for(cfg, rng, b=4, s=32):
    """b x (s + 1) tokens and a family's stub inputs, from `rng`."""
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.src_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["tokens"] = out["tokens"][:, :s + 1 - cfg.n_patches]
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def run(rank, store, arch, shape):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=shape[0] * shape[1], rank=rank)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config, rule_set_for
    from repro_torch.models.api import Model, ShapeSpec
    from repro_torch.models.config import (RULE_SETS, make_shardings,
                                           shard_ctx_for_mesh)
    from repro_torch.models.layers import (decl_logical, materialize,
                                           tree_leaves)
    from repro_torch.training.step import loss_and_grads

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    model = Model(get_config(arch, smoke=True))
    rules = RULE_SETS[rule_set_for(arch)]
    params = materialize(model.decls(), 0, device="cpu")
    batch = batch_for(model.cfg, np.random.default_rng(5))
    logical = model.input_logical(ShapeSpec("t", 32, 4, "train"))

    def placed(tree, logical):
        pl = make_shardings(logical, tree, rules, mesh)

        def walk(t, p):
            if isinstance(t, dict):
                return {k: walk(v, p[k]) for k, v in t.items()}
            return distribute_tensor(t, mesh, p)
        return walk(tree, pl)

    with implicit_replication():
        (loss, _), grads = loss_and_grads(
            model, placed(params, decl_logical(model.decls())),
            placed(batch, logical), shard_ctx_for_mesh(mesh))
    got = float(loss.full_tensor())
    grads = [g.full_tensor() for g in tree_leaves(grads)]
    if rank == 0:
        (want, _), ref = loss_and_grads(model, params, batch)
        err = max(float((g - r).norm() / max(float(r.norm()), 1e-30))
                  for g, r in zip(grads, tree_leaves(ref)))
        print(f"{arch} on {shape[0]}x{shape[1]}: loss {got!r} (one device "
              f"{float(want)!r}), largest gradient leaf error {err:.3e} "
              f"over {len(grads)} leaves", flush=True)
    dist.destroy_process_group()


def main():
    arch = sys.argv[1]
    shape = tuple(int(x) for x in (sys.argv[2] if len(sys.argv) > 2
                                   else "2x2").split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(os.path.join(tmp, "store"), arch, shape),
                 nprocs=shape[0] * shape[1])


if __name__ == "__main__":
    main()

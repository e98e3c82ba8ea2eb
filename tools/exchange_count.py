#!/usr/bin/env python3
"""The collectives of one LM train step on a gloo mesh, with the update's
gradient exchange and without it.

    python3 tools/exchange_count.py [ARCH] [DATAxMODEL]   (default
                                      internlm2-1.8b 2x1)

Spawns DATA x MODEL gloo processes on this host's CPU, places ARCH's
SMOKE parameters, AdamW state and a 4 x 16 batch by `make_shardings` as
the launcher does (`launch.train.placed`), and counts the collectives
DTensor issues in one `make_train_step` step (`CommDebugMode`): first
as the port runs it (`optim.optimizers.exchanged` reduces each partial
gradient once), then with `exchanged` passing the gradients through
unreduced, so that each update operation that cannot keep a gradient
partial reduces it again. Rank 0 prints both counts. Needs no card.
"""
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def counts(arch, mesh):
    """{collective: count} of one train step on `mesh`."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config, rule_set_for
    from repro_torch.data.pipeline import TokenSource
    from repro_torch.launch.train import placed
    from repro_torch.models.api import Model, ShapeSpec
    from repro_torch.models.config import (RULE_SETS, make_shardings,
                                           shard_ctx_for_mesh)
    from repro_torch.models.layers import (decl_logical, decl_shapes,
                                           materialize)
    from repro_torch.optim.optimizers import AdamW
    from repro_torch.training.step import make_train_step

    model = Model(get_config(arch, smoke=True))
    decls, rules, opt = model.decls(), RULE_SETS[rule_set_for(arch)], AdamW()
    params = materialize(decls, 0, device="cpu")
    state = opt.init(params)
    logical = decl_logical(decls)
    params = placed(params, make_shardings(logical, decl_shapes(decls),
                                           rules, mesh), mesh)
    state = placed(state, make_shardings(opt.state_logical(logical), state,
                                         rules, mesh), mesh)
    batch = {"tokens": torch.as_tensor(TokenSource(
        model.cfg.vocab, 16, 4, seed=0).batch_at(0)["tokens"])}
    batch = placed(batch, make_shardings(model.input_logical(
        ShapeSpec("t", 16, 4, "train")), batch, rules, mesh), mesh)
    step = make_train_step(model, opt, shard_ctx_for_mesh(mesh))
    with implicit_replication(), CommDebugMode() as comm:
        step(params, state, batch)
    return {str(k).split(".")[-1].rstrip("'>"): v
            for k, v in comm.get_comm_counts().items()}


def run(rank, store, arch, shape):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=shape[0] * shape[1], rank=rank)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.optim import optimizers
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    once = counts(arch, mesh)
    optimizers.exchanged = lambda grads, params: optimizers.tree_leaves(
        grads)
    again = counts(arch, mesh)
    if rank == 0:
        print(f"{arch} SMOKE, one train step on {shape[0]}x{shape[1]}: "
              f"{once} with the update's exchange; {again} with the "
              f"gradients left partial", flush=True)
    dist.destroy_process_group()


def main():
    arch = sys.argv[1] if len(sys.argv) > 1 else "internlm2-1.8b"
    shape = tuple(int(x) for x in (sys.argv[2] if len(sys.argv) > 2
                                   else "2x1").split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(os.path.join(tmp, "store"), arch, shape),
                 nprocs=shape[0] * shape[1])


if __name__ == "__main__":
    main()

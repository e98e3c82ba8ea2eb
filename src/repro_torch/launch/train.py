"""Training launcher: mesh-aware, resumable, with a straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 50 --smoke              # reduced config on the card
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --smoke --device cpu --dist-backend gloo     # a (4, 1) mesh

Port of `repro/launch/train.py`, with its flags, `--device` (default
cuda; ``cpu`` runs the plain PyTorch path; without a card and without
``--device cpu`` it raises) and `--dist-backend` (under torchrun: nccl,
one card a rank, by default on CUDA; gloo on the CPU, or on CUDA to let
the ranks share the cards). The parameters are materialized from seed 0,
the batches of `data.pipeline.TokenSource` (seed 0) are prefetched on a
thread and moved to the device, whisper's stub frames and llava's stub
patches are zeros, as the reference's. A checkpoint (params and
optimizer state, `checkpoint.store`) is written every --ckpt-every steps
and the run resumes from the latest one in --ckpt-dir: a resumed run
ends on the same parameters as an uninterrupted one. The loss is read to
the host every 10 steps (`lint.runtime.explicit_sync("loss")`).

On a mesh of more than one rank (torchrun's processes, `launch.mesh`)
every rank materializes the parameters and keeps its shard of each leaf
as `make_shardings` places it under the arch's rule set (the
reference's ``out_shardings``); the optimizer state and each step's
global batch are placed the same way, and `make_train_step` runs on the
DTensors: the parameters' gradients come back partial over the data
axis, and the update's reduction of them is the gradient exchange. A
checkpoint is gathered and written by rank 0 and restores onto any mesh.
Rank 0 alone prints.
"""
import argparse
import contextlib
import math
import os
import tempfile
import time


def stub_inputs(cfg, batch: int, device) -> dict:
    """The stubbed modality inputs of a family (whisper's frame
    embeddings, llava's patch embeddings): zeros on `device` in the
    activation dtype, the reference's."""
    import torch
    shape = {"encdec": ("frames", (batch, cfg.src_seq, cfg.d_model)),
             "vlm": ("patches", (batch, cfg.n_patches, cfg.vision_dim))}
    if cfg.family not in shape:
        return {}
    name, shp = shape[cfg.family]
    return {name: torch.zeros(shp, dtype=cfg.adtype, device=device)}


def device_batch(cfg, batch: dict, device) -> dict:
    """A pipeline batch (numpy) on `device`, with its stub inputs."""
    import torch
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out.update(stub_inputs(cfg, out["tokens"].shape[0], device))
    return out


def placed(tree, shardings, mesh):
    """`tree`'s tensors as DTensors over `mesh` with the placements of
    `shardings` (a tree of `make_shardings`' placements). Every rank
    holds the same whole tensors, so each keeps its own shard: no
    collective."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: placed(v, shardings[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, shardings, src_data_rank=None)


def whole(t):
    """A DTensor's full tensor (a collective every rank joins), or t."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def parser():
    from repro_torch.configs.registry import ARCH_IDS
    ap = argparse.ArgumentParser(
        description="train an LM skeleton architecture (resumable)")
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="the process group's backend under torchrun "
                         "(default nccl on CUDA, gloo on the CPU)")
    return ap


def main(argv=None):
    """The CLI: starts the process group under torchrun, builds the
    reference's mesh (--mesh) over it and trains (`train`)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh, start_group)

    args = parser().parse_args(argv)
    had_group = dist.is_initialized()
    dev = start_group(args.device, args.dist_backend)
    try:
        mesh = (make_host_mesh(device_type=dev.type) if args.mesh == "host"
                else make_production_mesh(multi_pod=args.mesh == "multi",
                                          device_type=dev.type))
        return train(args, mesh, dev)
    finally:
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()


def train(args, mesh, device, *, opt=None, on_step=None):
    """Train as `args` (the CLI's flags, `parser()`) says on `mesh` (a
    `launch.mesh.MeshShape` of one device, or a `DeviceMesh` over the
    process group's ranks) with this rank's tensors on `device`; returns
    the parameters (DTensors on a mesh of more than one rank).

    `opt`: the optimizer (default: the arch's, lr 1e-3, warmup 20, the
    reference's). `on_step(step, metrics)` runs on every rank after each
    step, the metrics device scalars (DTensors on a mesh)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.store import Checkpointer, latest_step
    from repro_torch.configs.registry import (get_config, optimizer_for,
                                              rule_set_for)
    from repro_torch.data.pipeline import Prefetcher, TokenSource
    from repro_torch.lint.runtime import explicit_sync
    from repro_torch.models.api import Model, ShapeSpec
    from repro_torch.models.config import (RULE_SETS, make_shardings,
                                           mesh_axes, shard_ctx_for_mesh)
    from repro_torch.models.layers import (decl_logical, decl_shapes,
                                           materialize, param_count)
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.training.step import StepWatchdog, make_train_step

    dev = torch.device(device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    axes = mesh_axes(mesh)
    ranks = math.prod(axes.values()) > 1
    loud = not dist.is_initialized() or dist.get_rank() == 0

    def say(text):
        if loud:
            print(text, flush=True)

    ctx = shard_ctx_for_mesh(mesh)
    decls = model.decls()
    say(f"{cfg.name}: {param_count(decls) / 1e6:.1f}M params, mesh "
        f"{axes} on {dev}")
    if opt is None:
        opt = get_optimizer(optimizer_for(args.arch), lr=1e-3, warmup=20)
    params = materialize(decls, 0, device=dev)
    opt_state = opt.init(params)
    shardings = batch_shard = None
    if ranks:
        rules = RULE_SETS[rule_set_for(args.arch)]
        logical = decl_logical(decls)
        shardings = {
            "params": make_shardings(logical, decl_shapes(decls), rules,
                                     mesh),
            "opt": make_shardings(opt.state_logical(logical), opt_state,
                                  rules, mesh)}
        params = placed(params, shardings["params"], mesh)
        opt_state = placed(opt_state, shardings["opt"], mesh)
        batch_logical = model.input_logical(
            ShapeSpec("train", args.seq, args.batch, "train"))
    step_fn = make_train_step(model, opt, ctx)

    ck = Checkpointer(args.ckpt_dir)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        restored, start, _ = ck.restore({"params": params, "opt": opt_state},
                                        shardings=shardings)
        params, opt_state = restored["params"], restored["opt"]
        say(f"resumed from step {start}")

    src = TokenSource(cfg.vocab, args.seq, args.batch, seed=0)
    pf = Prefetcher(src, start_step=start)
    wd = StepWatchdog()
    if ranks:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        on_mesh = implicit_replication
    else:
        on_mesh = contextlib.nullcontext
    t0 = time.time()
    try:
        for step, batch in pf:
            if step >= args.steps:
                break
            wd.start()
            batch = device_batch(cfg, batch, dev)
            if ranks:
                if batch_shard is None:
                    batch_shard = make_shardings(batch_logical, batch, rules,
                                                 mesh)
                batch = placed(batch, batch_shard, mesh)
            with on_mesh():
                params, opt_state, m = step_fn(params, opt_state, batch)
            slow = wd.stop()
            if on_step is not None:
                on_step(step, m)
            if step % 10 == 0:
                with explicit_sync("loss"):
                    loss = float(whole(m["loss"]))
                say(f"step {step:4d} loss {loss:.4f}"
                    f"{' [straggler]' if slow else ''}")
            if (step + 1) % args.ckpt_every == 0:
                with explicit_sync("checkpoint"):
                    ck.save(step + 1, {"params": params, "opt": opt_state},
                            meta={"step": step + 1})
    finally:
        pf.close()
        ck.wait()
    say(f"done in {time.time() - t0:.1f}s; watchdog flags: {wd.flagged}")
    return params


if __name__ == "__main__":
    main()

"""Training launcher: mesh-aware, resumable, with a straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 50 --smoke              # reduced config on the card
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Port of `repro/launch/train.py`, with its flags and `--device` (default
cuda; ``cpu`` runs the plain PyTorch path; without a card and without
``--device cpu`` it raises). One process trains on one device: the
parameters are materialized there from seed 0, the batches of
`data.pipeline.TokenSource` (seed 0) are prefetched on a thread and moved
to the device, whisper's stub frames and llava's stub patches are drawn
there from a generator seeded with the step. A checkpoint (params and
optimizer state, `checkpoint.store`) is written every --ckpt-every steps
and the run resumes from the latest one in --ckpt-dir: a resumed run
ends on the same parameters as an uninterrupted one. The loss is read to
the host every 10 steps (`lint.runtime.explicit_sync("loss")`).
"""
import argparse
import math
import os
import tempfile
import time


def stub_inputs(cfg, batch: int, step: int, device) -> dict:
    """The stubbed modality inputs of a family at `step` (whisper's frame
    embeddings, llava's patch embeddings), drawn on `device` from a
    generator seeded with the step, in the activation dtype."""
    import torch
    shape = {"encdec": ("frames", (batch, cfg.src_seq, cfg.d_model)),
             "vlm": ("patches", (batch, cfg.n_patches, cfg.vision_dim))}
    if cfg.family not in shape:
        return {}
    name, shp = shape[cfg.family]
    gen = torch.Generator(device=device)
    gen.manual_seed(step)
    return {name: torch.randn(shp, generator=gen, device=device).to(
        cfg.adtype)}


def device_batch(cfg, batch: dict, step: int, device) -> dict:
    """A pipeline batch (numpy) on `device`, with its stub inputs."""
    import torch
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out.update(stub_inputs(cfg, out["tokens"].shape[0], step, device))
    return out


def main(argv=None):
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
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.store import Checkpointer, latest_step
    from repro_torch.configs.registry import get_config, optimizer_for
    from repro_torch.core.api import resolve_device
    from repro_torch.data.pipeline import Prefetcher, TokenSource
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.lint.runtime import explicit_sync
    from repro_torch.models.api import Model
    from repro_torch.models.config import mesh_axes, shard_ctx_for_mesh
    from repro_torch.models.layers import materialize, param_count
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.training.step import StepWatchdog, make_train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    mesh = (make_host_mesh() if args.mesh == "host"
            else make_production_mesh(multi_pod=args.mesh == "multi"))
    axes = mesh_axes(mesh)
    if math.prod(axes.values()) > 1:
        raise SystemExit(f"mesh {axes}: the launcher trains one process on "
                         "one device (no gradient exchange across ranks)")
    ctx = shard_ctx_for_mesh(mesh)

    decls = model.decls()
    print(f"{cfg.name}: {param_count(decls) / 1e6:.1f}M params, mesh "
          f"{axes} on {dev}", flush=True)
    opt = get_optimizer(optimizer_for(args.arch), lr=1e-3, warmup=20)
    params = materialize(decls, 0, device=dev)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, ctx)

    ck = Checkpointer(args.ckpt_dir)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        restored, start, _ = ck.restore({"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        print(f"resumed from step {start}", flush=True)

    src = TokenSource(cfg.vocab, args.seq, args.batch, seed=0)
    pf = Prefetcher(src, start_step=start)
    wd = StepWatchdog()
    t0 = time.time()
    try:
        for step, batch in pf:
            if step >= args.steps:
                break
            wd.start()
            params, opt_state, m = step_fn(
                params, opt_state, device_batch(cfg, batch, step, dev))
            slow = wd.stop()
            if step % 10 == 0:
                with explicit_sync("loss"):
                    loss = float(m["loss"])
                print(f"step {step:4d} loss {loss:.4f}"
                      f"{' [straggler]' if slow else ''}", flush=True)
            if (step + 1) % args.ckpt_every == 0:
                with explicit_sync("checkpoint"):
                    ck.save(step + 1, {"params": params, "opt": opt_state},
                            meta={"step": step + 1})
    finally:
        pf.close()
        ck.wait()
    print(f"done in {time.time() - t0:.1f}s; watchdog flags: {wd.flagged}",
          flush=True)
    return params


if __name__ == "__main__":
    main()

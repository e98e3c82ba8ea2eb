"""Train a reduced-config LM on the PyTorch port with the full framework
stack (`examples/train_lm.py`'s twin): config registry, deterministic
data pipeline with prefetch, AdamW, atomic async checkpointing,
straggler watchdog, and resume-from-checkpoint, on the card.

    PYTHONPATH=src python examples/train_lm_torch.py --arch internlm2-1.8b \\
        --steps 100 [--resume] [--device cpu]

`--device cpu` runs the plain PyTorch path. The checkpoints have the
reference's layout: a run resumes from the reference's and back.
"""
import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.checkpoint.store import Checkpointer, latest_step
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.api import resolve_device
from repro_torch.data.pipeline import Prefetcher, TokenSource
from repro_torch.launch.train import device_batch
from repro_torch.lint.runtime import explicit_sync
from repro_torch.models.api import Model
from repro_torch.models.layers import materialize, param_count
from repro_torch.optim.optimizers import AdamW
from repro_torch.training.step import StepWatchdog, make_train_step


def reduced_config(arch: str, d_model: int = 256, layers: int = 4):
    """The reference's reduced config in the arch's family (~10M params,
    CPU-trainable)."""
    smoke = get_config(arch, smoke=True)
    heads = max(4, smoke.n_heads)
    return dataclasses.replace(
        smoke, d_model=d_model, n_layers=layers,
        n_heads=heads, n_kv_heads=max(2, smoke.kv_heads),
        d_ff=d_model * 3 if smoke.d_ff else 0, vocab=8192,
        head_dim=0, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch, args.d_model, args.layers)
    model = Model(cfg)
    dev = resolve_device(args.device)
    params = materialize(model.decls(), 0, device=dev)
    print(f"{cfg.name}: {param_count(model.decls())/1e6:.1f}M params")

    opt = AdamW(lr=1e-3, warmup=20)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    src = TokenSource(cfg.vocab, args.seq, args.batch, seed=0)
    ck = Checkpointer(args.ckpt_dir)
    wd = StepWatchdog()

    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        restored, start, _ = ck.restore({"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        print(f"resumed from step {start}")

    pf = Prefetcher(src, start_step=start)
    losses = {}
    t0 = time.time()
    try:
        for step, batch in pf:
            if step >= args.steps:
                break
            wd.start()
            # whisper's frames and llava's patches: zeros, as the
            # reference's
            params, opt_state, m = step_fn(params, opt_state,
                                           device_batch(cfg, batch, dev))
            slow = wd.stop()
            if step % 10 == 0 or step == args.steps - 1:
                with explicit_sync("loss"):
                    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                losses[step] = loss
                print(f"step {step:4d}  loss {loss:.4f}  gnorm {gnorm:.2f}"
                      f"{'  [straggler]' if slow else ''}", flush=True)
            if (step + 1) % args.ckpt_every == 0:
                with explicit_sync("checkpoint"):
                    ck.save(step + 1, {"params": params, "opt": opt_state},
                            meta={"step": step + 1}, background=True)
    finally:
        pf.close()
        ck.wait()
    print(f"{args.steps - start} steps in {time.time()-t0:.1f}s; "
          f"checkpoints in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()

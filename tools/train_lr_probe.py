#!/usr/bin/env python3
"""How internlm2-1.8b's FULL training loss moves under a few AdamW
learning rates on one GPU.

    python3 tools/train_lr_probe.py

For each (lr, warmup) of PROBES: the FULL config (bf16, remat on), its
parameters materialized on the card from seed 23, 30 steps of
`make_train_step` on 4 x 2048 tokens a step from `TokenSource` (seed
23, the batches on the card first); prints the mean step time (host
clock over the 30 steps to a synchronize), each step's loss and grad
norm, and the peak memory. It chose `chip_smoke.py`'s FULL_TRAIN_LR:
the launcher's lr 1e-3 made this loss rise. Needs a CUDA device.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: (lr, warmup) pairs to train with, each from the same initial weights.
PROBES = ((3e-4, 5), (1e-4, 5), (3e-5, 3))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_lr_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenSource
    from repro_torch.models.api import Model
    from repro_torch.models.layers import materialize
    from repro_torch.optim.optimizers import AdamW
    from repro_torch.training.step import make_train_step

    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2-1.8b")
    model = Model(cfg)
    src = TokenSource(cfg.vocab, 2048, 4, seed=23)
    batches = [{"tokens": torch.as_tensor(src.batch_at(k)["tokens"],
                                          device=dev)} for k in range(30)]
    for lr, warmup in PROBES:
        params = materialize(model.decls(), 23, device=dev)
        opt = AdamW(lr=lr, warmup=warmup)
        state = opt.init(params)
        step = make_train_step(model, opt)
        losses, gnorms = [], []
        torch.cuda.synchronize()
        t0 = time.time()
        for batch in batches:
            params, state, m = step(params, state, batch)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        torch.cuda.synchronize()
        dt = (time.time() - t0) / len(batches)
        print(f"lr {lr} warmup {warmup}: {dt * 1e3:.1f} ms a step; loss "
              + " ".join(f"{float(x):.3f}" for x in losses), flush=True)
        print("   gnorm " + " ".join(f"{float(x):.3f}" for x in gnorms),
              flush=True)
        del params, state, opt
        torch.cuda.empty_cache()
    print("peak GiB", torch.cuda.max_memory_allocated() / 2**30)
    return 0


if __name__ == "__main__":
    sys.exit(main())

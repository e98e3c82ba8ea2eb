#!/usr/bin/env python3
"""How far an LM arch's bf16 serving path stands from its f32 one.

    python3 tools/lm_bf16_noise.py [--arch mamba2-1.3b] [--layers 8]
        [--prompt 512] [--steps 12] [--device cuda|cpu]

Takes the arch's FULL config (width as published, depth cut to
``--layers``), materializes its weights in bf16 from a seed, and on one
request of ``--prompt`` random tokens and ``--steps`` decode steps (fed
the same tokens) prints, per step, the relative 2-norm of:

- the bf16 decode's logits against the bf16 full forward's;
- the bf16 full forward against the f32 one on the same (bf16-valued)
  weights: bf16's own error on this model;
- the f32 decode against the f32 full forward (the cache path);

and the f32 full forward's change when the embedding table is scaled by
(1 + 2^-9 N(0, 1)), one bf16 rounding: how much the model amplifies a
rounding. With random weights that grows with depth, and it sets what
the bf16 checks of `chip_smoke.py` phase 16c can ask. Runs on the card
unless ``--device cpu`` (TF32 off).
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import resolve_device
    from repro_torch.models.api import Model
    from repro_torch.models.layers import materialize, tree_map

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    dev = resolve_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = dataclasses.replace(get_config(a.arch), n_layers=a.layers)
    if cfg16.family not in ("dense", "moe", "ssm", "hybrid"):
        raise SystemExit(f"{a.arch}: a token-only family is needed")
    cfg32 = dataclasses.replace(cfg16, dtype="float32", param_dtype="float32")
    p16 = materialize(Model(cfg16).decls(), 21, device=dev)
    p32 = tree_map(lambda t: t.float(), p16)
    toks = torch.as_tensor(np.random.default_rng(3001).integers(
        0, cfg16.vocab, (1, a.prompt + a.steps)).astype("int32"), device=dev)

    def serve(cfg, params):
        """(decode logits, full forward logits) at the decoded positions."""
        model = Model(cfg)
        logits, cache = model.prefill(params, {"tokens": toks[:, :a.prompt]},
                                      device=dev)
        outs = []
        for i in range(a.prompt, a.prompt + a.steps):
            logits, cache = model.decode(params, {
                "tokens": toks[:, i:i + 1], "cache": cache})
            outs.append(logits)
        full = forward(cfg, params)
        return torch.cat(outs, 1).double(), full

    def forward(cfg, params):
        from repro_torch.models import mamba2 as mb
        from repro_torch.models import transformer as tf
        fn = {"ssm": mb.mamba_lm_apply, "hybrid": mb.zamba_apply}.get(
            cfg.family, tf.lm_apply)
        return fn(cfg, params, toks)[0][:, a.prompt:].double()

    def errs(x, y):
        return " ".join(f"{float((x[:, i] - y[:, i]).norm() / y[:, i].norm()):.3e}"
                        for i in range(a.steps))

    d16, f16 = serve(cfg16, p16)
    d32, f32 = serve(cfg32, p32)
    gen = torch.Generator(device=dev).manual_seed(5)
    embed = p32["embed"]
    bumped = forward(cfg32, dict(p32, embed=embed * (1 + 2.0 ** -9 * torch.randn(
        embed.shape, generator=gen, device=dev))))
    bump = float((bumped - f32).norm() / f32.norm())
    print(f"{a.arch} FULL width, {a.layers} layers, {a.prompt} prompt tokens "
          f"+ {a.steps} steps on {dev}; per step:")
    print(f"  bf16 decode vs bf16 full forward: {errs(d16, f16)}")
    print(f"  bf16 full forward vs f32:         {errs(f16, f32)}")
    print(f"  f32 decode vs f32 full forward:   {errs(d32, f32)}")
    print(f"  f32 full forward, embedding x (1 + 2^-9 N(0,1)): {bump:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

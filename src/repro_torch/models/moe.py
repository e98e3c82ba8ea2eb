"""Mixture-of-Experts layer: top-k routing, capacity-based one-hot dispatch.

Static shapes: tokens are split into fixed-size groups; each group
dispatches into (E, C) capacity slots via one-hot einsums (the
Switch/Mesh-TF formulation). Overflowing tokens are dropped
(capacity_factor controls the drop rate); the router aux loss pushes
toward balanced load.

Top-k breaks ties towards the lower expert index, as `jax.lax.top_k`
does (`torch.topk` promises no order among equal values), so the port
routes every token to the reference's experts.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import NO_SHARD, ModelConfig, ShardCtx
from repro_torch.models.layers import activate, dense_init

def moe_init(cfg: ModelConfig, layers: Optional[int] = None):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    lead = (layers,) if layers else ()
    llog = ("layers",) if layers else ()
    p = {
        "router": dense_init(lead + (d, e), llog + ("embed", "experts"),
                             torch.float32, fan_in=d),
        "wu": dense_init(lead + (e, d, f),
                         llog + ("experts", "embed", "expert_mlp"),
                         cfg.pdtype, fan_in=d),
        "wo": dense_init(lead + (e, f, d),
                         llog + ("experts", "expert_mlp", "embed2"),
                         cfg.pdtype, fan_in=f,
                         scale=1.0 / np.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.act.endswith("_glu"):
        p["wg"] = dense_init(lead + (e, d, f),
                             llog + ("experts", "embed", "expert_mlp"),
                             cfg.pdtype, fan_in=d)
    return p


def _capacity(cfg: ModelConfig, group: int) -> int:
    c = int(np.ceil(group * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, -(-c // 4) * 4)  # multiple of 4, >= 4


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows of `idx` over n classes, by comparison with
    arange(n) as `jax.nn.one_hot` does (`F.one_hot` reads the indices'
    range to the host on the CPU)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis, largest first, equal values
    in index order (`jax.lax.top_k`'s order): (values, int64 indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor,
              ctx: ShardCtx = NO_SHARD):
    """x (B, S, D) -> (y (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    group = min(cfg.moe_group, t)
    if t % group:
        raise ValueError(f"tokens {t} not divisible by moe group {group}")
    g = t // group
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, group)

    xg = x.reshape(g, group, d)
    logits = (xg @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)              # (G, Sg, E)
    gate_w, gate_i = top_k(probs, k)                   # (G, Sg, K)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    counts = torch.zeros((g, e), dtype=torch.float32, device=x.device)
    dispatch = torch.zeros((g, group, e, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((g, group, e, cap), dtype=torch.float32,
                          device=x.device)
    for j in range(k):
        oh = one_hot(gate_i[..., j], e)
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        keep = oh * (pos < cap)
        counts = counts + keep.sum(dim=1)
        slot = one_hot(torch.clamp(pos, max=cap - 1).to(torch.int64),
                       cap) * keep[..., None]
        dispatch = dispatch + slot.to(x.dtype)
        combine = combine + slot * gate_w[..., j, None, None]

    exp_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    exp_in = ctx.constrain(exp_in, "tp", "dp", None, None)
    u = torch.einsum("egcd,edf->egcf", exp_in, p["wu"].to(x.dtype))
    gate = (torch.einsum("egcd,edf->egcf", exp_in, p["wg"].to(x.dtype))
            if cfg.act.endswith("_glu") else None)
    h = activate(cfg.act, gate, u)
    out_e = torch.einsum("egcf,efd->egcd", h, p["wo"].to(x.dtype))
    out_e = ctx.constrain(out_e, "tp", "dp", None, None)
    y = torch.einsum("egcd,gsec->gsd", out_e, combine.to(x.dtype))

    # Switch-style load-balance aux loss: E * sum_e f_e * P_e.
    frac = dispatch.to(torch.float32).sum(dim=(1, 3)) / group   # (G, E)
    mean_p = probs.mean(dim=1)                                  # (G, E)
    aux = e * torch.mean(torch.sum(frac * mean_p, dim=-1))
    return y.reshape(b, s, d), aux

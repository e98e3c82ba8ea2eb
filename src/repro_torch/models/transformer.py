"""Decoder-only transformer LM (dense, GQA, optional MoE / dense+MoE).

One block implementation serves the loss (no cache), prefill (emits the
KV cache) and decode (consumes + updates the cache). Layers are stacked
on a leading `layers` axis, unbound once into per-layer views
(`layers.unstack`) and run by a loop (the reference's lax.scan); in
training each block is rematerialized under cfg.remat (`layers.remat`).

Decode reads nothing to the host: the cache's position is a device
scalar, the new K/V are written at pos + arange(s) in place
(`layers.cache_write`) and the attention mask is formed on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import moe as moe_mod
from repro_torch.models.config import NO_SHARD, ModelConfig, ShardCtx
from repro_torch.models.layers import (
    apply_norm, attn_init, attn_out, attn_qkv, attention, cache_write,
    cross_entropy, dense_init, embed_init, embed_tokens, fused_cross_entropy,
    logits_out, meta, mlp_apply, mlp_init, norm_init, remat, unstack)


def lm_decls(cfg: ModelConfig):
    """Declarative parameter tree (see layers.materialize/decl_shapes)."""
    l, d, v = cfg.n_layers, cfg.d_model, cfg.vocab
    blocks = {
        "attn_norm": norm_init(cfg, (l, d), ("layers", "embed")),
        "attn": attn_init(cfg, layers=l),
        "mlp_norm": norm_init(cfg, (l, d), ("layers", "embed")),
    }
    if cfg.n_experts:
        blocks["moe"] = moe_mod.moe_init(cfg, layers=l)
        if cfg.moe_dense_ff:
            blocks["mlp"] = mlp_init(cfg, d_ff=cfg.moe_dense_ff, layers=l)
    elif cfg.d_ff:
        blocks["mlp"] = mlp_init(cfg, layers=l)
    tree = {
        "embed": embed_init((v, d), ("vocab", "embed"), cfg.pdtype),
        "blocks": blocks,
        "final_norm": norm_init(cfg, (d,), ("embed",)),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init((d, v), ("embed", "vocab"), cfg.pdtype,
                                     fan_in=d)
    return tree


def positions_from(start, b: int, s: int, device):
    """(B, S) absolute positions start + arange(s); start an int or a
    device scalar."""
    pos = torch.arange(s, device=device)[None] + start
    return pos.expand(b, s)


def _block(cfg, ctx, h, aux, lp, kc, vc, positions, start, mode):
    a_in = apply_norm(cfg, h, lp["attn_norm"])
    q, k, v = attn_qkv(cfg, lp["attn"], a_in, positions)
    if mode == "decode":
        kc = cache_write(kc, k, start)
        vc = cache_write(vc, v, start)
        kv_len = (start + q.shape[1]).expand(h.shape[0])
        out = attention(cfg, q, kc, vc, positions, kv_len=kv_len,
                        causal=True, ctx=ctx)
        ys = (kc, vc)
    else:
        out = attention(cfg, q, k, v, positions, causal=True, ctx=ctx)
        ys = (k, v) if mode == "prefill" else None
    h = h + attn_out(lp["attn"], out).to(h.dtype)
    m_in = apply_norm(cfg, h, lp["mlp_norm"])
    delta = None
    if "mlp" in lp:
        delta = mlp_apply(cfg, lp["mlp"], m_in, ctx)
    if "moe" in lp:
        mo, a = moe_mod.moe_apply(cfg, lp["moe"], m_in, ctx)
        delta = mo if delta is None else delta + mo
        aux = aux + a
    h = ctx.constrain(h + delta, "dp", None,
                      "tp" if cfg.shard_residual else None)
    return h, aux, ys


def forward_hidden(cfg: ModelConfig, params, h, positions, *,
                   ctx: ShardCtx = NO_SHARD, cache=None, start=0,
                   mode: str = "train"):
    """Run the block stack. Returns (h, aux, cache_ys): in prefill the
    stacked (k, v) (L, B, S, Hk, hd); in decode the cache's own k and v,
    updated in place."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs = [], []
    for i, lp in enumerate(unstack(params["blocks"])):
        if mode == "train":
            h, aux, _ = remat(cfg, _block, cfg, ctx, h, aux, lp, None, None,
                              positions, start, mode)
            continue
        kc, vc = ((cache["k"][i], cache["v"][i]) if mode == "decode"
                  else (None, None))
        h, aux, ys = _block(cfg, ctx, h, aux, lp, kc, vc, positions, start,
                            mode)
        if mode == "prefill":
            ks.append(ys[0])
            vs.append(ys[1])
    if mode == "prefill":
        return h, aux, (torch.stack(ks), torch.stack(vs))
    if mode == "decode":
        return h, aux, (cache["k"], cache["v"])
    return h, aux, None


def lm_apply(cfg: ModelConfig, params, tokens, *, ctx: ShardCtx = NO_SHARD,
             cache=None, start=0, mode: str = "train"):
    """tokens (B, S) -> (logits (B, S, V), aux, cache_ys)."""
    b, s = tokens.shape
    positions = positions_from(start if mode == "decode" else 0, b, s,
                               tokens.device)
    h = embed_tokens(params["embed"], tokens, cfg.adtype)
    h = ctx.constrain(h, "dp", None, None)
    h, aux, ys = forward_hidden(cfg, params, h, positions, ctx=ctx,
                                cache=cache, start=start, mode=mode)
    h = apply_norm(cfg, h, params["final_norm"])
    logits = logits_out(cfg, params, h, ctx)
    return logits, aux, ys


def lm_loss(cfg: ModelConfig, params, batch, *, ctx: ShardCtx = NO_SHARD):
    """The training loss (the total: CE + aux_loss_coef * aux) and its
    metrics; `training.step` differentiates it."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    if cfg.ce_chunk:
        # fused CE path: full (B, S, V) logits never materialize
        b, s = inp.shape
        positions = positions_from(0, b, s, inp.device)
        h = embed_tokens(params["embed"], inp, cfg.adtype)
        h = ctx.constrain(h, "dp", None, None)
        h, aux, _ = forward_hidden(cfg, params, h, positions, ctx=ctx)
        h = apply_norm(cfg, h, params["final_norm"])
        loss = fused_cross_entropy(cfg, params, h, labels, ctx)
    else:
        logits, aux, _ = lm_apply(cfg, params, inp, ctx=ctx)
        loss = cross_entropy(logits, labels)
    total = loss + cfg.aux_loss_coef * aux
    return total, {"loss": loss, "aux_loss": aux}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def pad_seq(t, cache_len: int, dim: int = 2):
    """Zero-pad axis `dim` of t up to cache_len."""
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, cache_len - t.shape[dim]]
    return F.pad(t, pad)


def position_scalar(s: int, device):
    """The cache's position: an int32 device scalar (a fill, no upload)."""
    return torch.full((), s, dtype=torch.int32, device=device)


def lm_prefill(cfg: ModelConfig, params, tokens, *, cache_len: int,
               ctx: ShardCtx = NO_SHARD):
    """Prefill: logits for the prompt + a KV cache padded to cache_len."""
    s = tokens.shape[1]
    logits, _, (k, v) = lm_apply(cfg, params, tokens, ctx=ctx, mode="prefill")
    cache = {"k": pad_seq(k, cache_len), "v": pad_seq(v, cache_len),
             "pos": position_scalar(s, tokens.device)}
    return logits, cache


def lm_decode(cfg: ModelConfig, params, tokens, cache, *,
              ctx: ShardCtx = NO_SHARD):
    """One decode step: tokens (B, S) + cache -> (logits, updated cache).

    Requires pos + S <= cache_len (not checked: that would read pos to
    the host). The returned cache shares storage with `cache`: its k and
    v are written in place."""
    logits, _, (k, v) = lm_apply(cfg, params, tokens, ctx=ctx,
                                 cache=cache, start=cache["pos"],
                                 mode="decode")
    return logits, {"k": k, "v": v, "pos": cache["pos"] + tokens.shape[1]}


def kv_cache_shape(cfg: ModelConfig, batch: int, cache_len: int):
    """Meta tensors for a decode-step cache (dry-run input specs)."""
    shp = (cfg.n_layers, batch, cache_len, cfg.kv_heads, cfg.hd)
    return {
        "k": meta(shp, cfg.adtype),
        "v": meta(shp, cfg.adtype),
        "pos": meta((), torch.int32),
    }


def kv_cache_logical(cfg: ModelConfig):
    """Logical axes for the cache (sharded like activations)."""
    return {"k": ("layers", "batch", "seq", "kv_heads", "head_dim"),
            "v": ("layers", "batch", "seq", "kv_heads", "head_dim"),
            "pos": ()}

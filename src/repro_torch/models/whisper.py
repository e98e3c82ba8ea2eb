"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Only the transformer backbone is modeled: `input_specs` provides
precomputed frame embeddings (B, src_seq, D) standing in for the
conv1d+GELU audio frontend. Encoder: bidirectional attention + learned
positions; decoder: causal self-attention + cross-attention into the
encoder output. Serving caches both the self-attn KV and the (computed
once at prefill) cross-attn KV. In training each encoder and decoder
block is rematerialized under cfg.remat, saving nothing inside (the
reference's nothing_saveable, whatever cfg.remat_policy says).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import NO_SHARD, ModelConfig, ShardCtx
from repro_torch.models.layers import (
    apply_norm, attn_init, attn_out, attn_qkv, attention, cache_write,
    checkpointed, cross_entropy, embed_init, embed_tokens, meta, mlp_apply,
    mlp_init, norm_init, split_heads, unstack)
from repro_torch.models.transformer import (
    pad_seq, position_scalar, positions_from)


def whisper_decls(cfg: ModelConfig):
    d = cfg.d_model
    el, dl = cfg.enc_layers, cfg.n_layers

    def _stack(n):
        return {
            "attn_norm": norm_init(cfg, (n, d), ("layers", "embed")),
            "attn": attn_init(cfg, layers=n),
            "mlp_norm": norm_init(cfg, (n, d), ("layers", "embed")),
            "mlp": mlp_init(cfg, layers=n),
        }

    dec = _stack(dl)
    dec["xattn_norm"] = norm_init(cfg, (dl, d), ("layers", "embed"))
    dec["xattn"] = attn_init(cfg, layers=dl)
    return {
        "enc_pos": embed_init((cfg.src_seq, d), ("seq", "embed"), cfg.pdtype),
        "enc_blocks": _stack(el),
        "enc_final_norm": norm_init(cfg, (d,), ("embed",)),
        "embed": embed_init((cfg.vocab, d), ("vocab", "embed"), cfg.pdtype),
        "dec_pos": embed_init((4096 * 16, d), ("seq", "embed"), cfg.pdtype),
        "dec_blocks": dec,
        "final_norm": norm_init(cfg, (d,), ("embed",)),
    }


def _remat(cfg, fn, *args):
    return checkpointed(fn, *args) if cfg.remat else fn(*args)


def _enc_block(cfg, ctx, positions, lp, h):
    a_in = apply_norm(cfg, h, lp["attn_norm"])
    q, k, v = attn_qkv(cfg, lp["attn"], a_in, positions, use_rope=False,
                       ctx=ctx)
    out = attention(cfg, q, k, v, positions, causal=False, ctx=ctx)
    h = h + attn_out(lp["attn"], out, ctx).to(h.dtype)
    m_in = apply_norm(cfg, h, lp["mlp_norm"])
    return ctx.constrain(h + mlp_apply(cfg, lp["mlp"], m_in, ctx),
                         "dp", None, None)


def _dec_block(cfg, ctx, positions, lp, h, enc_out, kc=None, vc=None,
               xkv=None, start=0):
    """One decoder block: causal self-attention (into the cache kc / vc
    in decode, written in place), cross-attention into enc_out (or the
    cached cross K/V xkv), the MLP. Returns (h, self k, self v, xk, xv)."""
    b, s = h.shape[:2]
    a_in = apply_norm(cfg, h, lp["attn_norm"])
    q, k, v = attn_qkv(cfg, lp["attn"], a_in, positions, use_rope=False,
                       ctx=ctx)
    if kc is not None:
        kc = cache_write(kc, k, start)
        vc = cache_write(vc, v, start)
        kv_len = (start + s).expand(b)
        out = attention(cfg, q, kc, vc, positions, kv_len=kv_len,
                        causal=True, ctx=ctx)
    else:
        out = attention(cfg, q, k, v, positions, causal=True, ctx=ctx)
    h = h + attn_out(lp["attn"], out, ctx).to(h.dtype)

    # cross attention
    x_in = apply_norm(cfg, h, lp["xattn_norm"])
    xq = split_heads(x_in @ lp["xattn"]["wq"], cfg.n_heads, cfg.hd, ctx)
    if xkv is not None:
        xk, xv = xkv
    else:
        xk = split_heads(enc_out @ lp["xattn"]["wk"], cfg.kv_heads, cfg.hd,
                         ctx)
        xv = split_heads(enc_out @ lp["xattn"]["wv"], cfg.kv_heads, cfg.hd,
                         ctx)
    out = attention(cfg, xq, xk, xv, positions, causal=False, ctx=ctx)
    h = h + attn_out(lp["xattn"], out, ctx).to(h.dtype)

    m_in = apply_norm(cfg, h, lp["mlp_norm"])
    h = ctx.constrain(h + mlp_apply(cfg, lp["mlp"], m_in, ctx),
                      "dp", None, None)
    return h, k, v, xk, xv


def encode(cfg: ModelConfig, params, frames, *, ctx: ShardCtx = NO_SHARD):
    """frames (B, src_seq, D) stub embeddings -> encoder output (B, S, D)."""
    b, s, _ = frames.shape
    h = frames.to(cfg.adtype) + params["enc_pos"][None, :s].to(cfg.adtype)
    h = ctx.constrain(h, "dp", None, None)
    positions = positions_from(0, frames)
    for lp in unstack(params["enc_blocks"]):
        h = _remat(cfg, _enc_block, cfg, ctx, positions, lp, h)
    return apply_norm(cfg, h, params["enc_final_norm"])


def decode_stack(cfg: ModelConfig, params, tokens, enc_out, *,
                 ctx: ShardCtx = NO_SHARD, cache=None, start=0, mode="train"):
    """Decoder over target tokens with cross-attention into enc_out.

    cache = {"k","v" (self), "xk","xv" (cross), "pos"} for decode mode,
    the self K/V written in place; in prefill mode the cross KV is
    computed from enc_out and emitted.
    """
    b, s = tokens.shape
    positions = positions_from(start if mode == "decode" else 0, tokens)
    h = embed_tokens(params["embed"], tokens, cfg.adtype)
    if mode == "decode":  # start is a device scalar: gather the rows
        ppos = params["dec_pos"].index_select(0, positions[0])
    else:
        ppos = params["dec_pos"][:s]
    h = h + ppos[None].to(h.dtype)
    h = ctx.constrain(h, "dp", None, None)

    ys = []
    for i, lp in enumerate(unstack(params["dec_blocks"])):
        if mode == "train":
            h = _remat(cfg, lambda lp_, h_, e_: _dec_block(
                cfg, ctx, positions, lp_, h_, e_)[0], lp, h, enc_out)
        elif mode == "decode":
            h, *_ = _dec_block(cfg, ctx, positions, lp, h, None,
                               cache["k"][i], cache["v"][i],
                               (cache["xk"][i], cache["xv"][i]), start)
        else:
            h, *kv = _dec_block(cfg, ctx, positions, lp, h, enc_out)
            ys.append(tuple(kv))
    h = apply_norm(cfg, h, params["final_norm"])
    # whisper ties output logits to the token embedding table
    logits = ctx.constrain(h @ params["embed"].T.to(h.dtype),
                           "dp", None, "tp")
    if mode == "prefill":
        return logits, tuple(torch.stack(t) for t in zip(*ys))
    if mode == "decode":
        return logits, (cache["k"], cache["v"])
    return logits, None


def whisper_loss(cfg, params, batch, *, ctx: ShardCtx = NO_SHARD):
    enc_out = encode(cfg, params, batch["frames"], ctx=ctx)
    tokens = batch["tokens"]
    logits, _ = decode_stack(cfg, params, tokens[:, :-1], enc_out, ctx=ctx)
    loss = cross_entropy(logits, tokens[:, 1:], ctx=ctx)
    return loss, {"loss": loss}


def whisper_prefill(cfg, params, frames, tokens, *, cache_len: int,
                    ctx: ShardCtx = NO_SHARD):
    enc_out = encode(cfg, params, frames, ctx=ctx)
    logits, (k, v, xk, xv) = decode_stack(cfg, params, tokens, enc_out,
                                          ctx=ctx, mode="prefill")
    cache = {"k": pad_seq(k, cache_len), "v": pad_seq(v, cache_len),
             "xk": xk, "xv": xv,
             "pos": position_scalar(tokens.shape[1], tokens.device)}
    return logits, cache


def whisper_decode(cfg, params, tokens, cache, *, ctx: ShardCtx = NO_SHARD):
    """One decode step; the returned cache shares storage with `cache`
    (its self K/V written in place; pos + S <= cache_len is the caller's
    to keep)."""
    logits, (k, v) = decode_stack(cfg, params, tokens, None, ctx=ctx,
                                  cache=cache, start=cache["pos"],
                                  mode="decode")
    new = dict(cache, k=k, v=v, pos=cache["pos"] + tokens.shape[1])
    return logits, new


def whisper_cache_shape(cfg: ModelConfig, batch: int, cache_len: int):
    l = cfg.n_layers
    self_kv = (l, batch, cache_len, cfg.kv_heads, cfg.hd)
    cross_kv = (l, batch, cfg.src_seq, cfg.kv_heads, cfg.hd)
    dt = cfg.adtype
    return {"k": meta(self_kv, dt), "v": meta(self_kv, dt),
            "xk": meta(cross_kv, dt), "xv": meta(cross_kv, dt),
            "pos": meta((), torch.int32)}


def whisper_cache_logical(cfg: ModelConfig):
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": ()}

"""Mamba2 (SSD, state-space duality) and the Zamba2 hybrid.

The SSD layer computes, per head h with per-head scalar decay A_h < 0,

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,     y_t = C_t S_t + D x_t

using the chunked block decomposition of Dao & Gu (2024): within a chunk
of length Q the output is an attention-like (Q x Q) masked matmul; across
chunks a loop carries the (H, P, N) state. The recurrent form serves
decode and is the equivalence oracle in tests.

Zamba2 = a Mamba2 backbone with ONE shared transformer block applied every
`attn_every` layers: its input is [h, h_embed0] concatenated and projected,
its output added back through a per-invocation linear (the weight-shared
global-attention pattern of the Zamba papers).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import NO_SHARD, ModelConfig, ShardCtx
from repro_torch.models.layers import (
    apply_norm, attn_init, attn_out, attn_qkv, attention, cache_write,
    cross_entropy, dense_init, embed_init, embed_tokens, from_shards,
    fused_cross_entropy, is_dtensor, local, logits_out, meta, mlp_apply,
    mlp_init, model_axis_divides, norm_init, ones_init, remat,
    replicated_like, rms_norm, unstack, zeros_init)
from repro_torch.models.transformer import (
    pad_seq, position_scalar, positions_from)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def ssm_block_decls(cfg: ModelConfig, layers: Optional[int] = None):
    l = layers
    lead = (l,) if l else ()
    llog = ("layers",) if l else ()
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    return {
        "norm": norm_init(cfg, lead + (d,), llog + ("embed",)),
        "wz": dense_init(lead + (d, di), llog + ("embed", "ssm_inner"),
                         cfg.pdtype, fan_in=d),
        "wx": dense_init(lead + (d, di), llog + ("embed", "ssm_inner"),
                         cfg.pdtype, fan_in=d),
        "wB": dense_init(lead + (d, g * n), llog + ("embed", "state"),
                         cfg.pdtype, fan_in=d),
        "wC": dense_init(lead + (d, g * n), llog + ("embed", "state"),
                         cfg.pdtype, fan_in=d),
        "wdt": dense_init(lead + (d, h), llog + ("embed", "ssm_heads"),
                          cfg.pdtype, fan_in=d),
        "conv_x": dense_init(lead + (k, di), llog + (None, "ssm_inner"),
                             cfg.pdtype, fan_in=k),
        "conv_B": dense_init(lead + (k, g * n), llog + (None, "state"),
                             cfg.pdtype, fan_in=k),
        "conv_C": dense_init(lead + (k, g * n), llog + (None, "state"),
                             cfg.pdtype, fan_in=k),
        "conv_bias_x": zeros_init(lead + (di,), llog + ("ssm_inner",), cfg.pdtype),
        "conv_bias_B": zeros_init(lead + (g * n,), llog + ("state",), cfg.pdtype),
        "conv_bias_C": zeros_init(lead + (g * n,), llog + ("state",), cfg.pdtype),
        "A_log": zeros_init(lead + (h,), llog + ("ssm_heads",), torch.float32),
        "D": ones_init(lead + (h,), llog + ("ssm_heads",), torch.float32),
        "dt_bias": zeros_init(lead + (h,), llog + ("ssm_heads",), torch.float32),
        "gate_norm": ones_init(lead + (di,), llog + ("ssm_inner",), cfg.pdtype),
        "wo": dense_init(lead + (di, d), llog + ("ssm_inner", "embed2"),
                         cfg.pdtype, fan_in=di,
                         scale=1.0 / np.sqrt(2 * max(cfg.n_layers, 1))),
    }


def mamba_lm_decls(cfg: ModelConfig):
    tree = {
        "embed": embed_init((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                            cfg.pdtype),
        "blocks": ssm_block_decls(cfg, layers=cfg.n_layers),
        "final_norm": norm_init(cfg, (cfg.d_model,), ("embed",)),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"), cfg.pdtype,
                                     fan_in=cfg.d_model)
    return tree


# --------------------------------------------------------------------------
# core SSD math
# --------------------------------------------------------------------------


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv, kernel k. x (B, L, C), w (k, C), b (C,).

    With a cache (B, k-1, C) of trailing pre-conv inputs, returns the conv
    over [cache; x] (decode path). Returns (y, new_cache)."""
    k = w.shape[0]
    hist = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                        device=x.device) if cache is None else cache)
    xp = torch.cat([hist, x], dim=1)
    l = x.shape[1]
    f32 = torch.float32                # the chain in f32, rounded once
    y = sum(w[i].to(f32) * xp[:, i:i + l].to(f32) for i in range(k))
    new_cache = xp[:, -(k - 1):, :] if k > 1 else hist
    return F.silu(y + b.to(f32)).to(x.dtype), new_cache


def _split_heads(cfg, x, bm, c, dt):
    """-> x (B,L,G,Hg,P), B/C (B,L,G,N), dt (B,L,G,Hg)."""
    b, l = x.shape[:2]
    g, n, hh = cfg.ssm_groups, cfg.ssm_state, x.shape[2]
    hg, p = hh // g, cfg.ssm_head_dim
    return (x.reshape(b, l, g, hg, p), bm.reshape(b, l, g, n),
            c.reshape(b, l, g, n), dt.reshape(b, l, g, hg))


def ssd_chunked(cfg: ModelConfig, x, bm, c, dt, a_head, init_state=None):
    """Chunked SSD scan.

    Args: x (B,L,H,P) via grouped reshape, bm/c (B,L,G*N), dt (B,L,H) > 0,
      a_head (H,) = -exp(A_log) < 0. init_state optional (B,G,Hg,N,P).
    Returns: y (B,L,G,Hg,P), final_state (B,G,Hg,N,P).

    The intra-chunk decay exp(cum_i - cum_j) is taken on the lower
    triangle only: `seg` is -inf above the diagonal before the exp, where
    the reference takes exp of the (positive) entries there and then
    drops them. The lower triangle is bitwise the same. The running sum
    `cum` is f32 whatever the compute dtype: the reference's bf16 sum
    loses the decay deep in a chunk, which the bf16 FULL configs of
    mamba2 and zamba2 meet (`tests/test_torch_bf16.py` holds both to an
    f32 scan over the last 32 positions of a 256-chunk).
    """
    b, l0 = dt.shape[:2]
    q = min(cfg.ssm_chunk, l0)
    pad = (-l0) % q
    if pad:  # dt = 0 on padding => identity decay, zero input: state exact
        x, bm, c, dt = (pad_seq(t, l0 + pad, dim=1) for t in (x, bm, c, dt))
    l = l0 + pad
    nc = l // q
    x, bm, c, dt = _split_heads(cfg, x, bm, c, dt)
    g, hg = x.shape[2], x.shape[3]
    n, p = bm.shape[-1], x.shape[-1]
    f32 = torch.float32

    a = dt * a_head.reshape(1, 1, g, hg)                    # (B,L,G,Hg) <= 0
    xc = x.reshape(b, nc, q, g, hg, p)
    bc = bm.reshape(b, nc, q, g, n)
    cc = c.reshape(b, nc, q, g, n)
    dtc = dt.reshape(b, nc, q, g, hg)
    ac = a.reshape(b, nc, q, g, hg)
    # the decay's running sum in f32: in bf16 (the reference's) it carries
    # ~2^-9 of |cum|, up to Q * max(dt |a|), into every exp(cum_i - cum_j)
    cum = torch.cumsum(ac.to(f32), dim=2)                   # (B,nc,Q,G,Hg)

    # Intra-chunk (the "attention-like" diagonal block), accumulated in f32.
    cb = torch.einsum("bcign,bcjgn->bcgij", cc.to(f32), bc.to(f32))
    seg = cum[:, :, :, None] - cum[:, :, None, :, :, :]
    # seg[b,c,i,j,g,h] = cum_i - cum_j ; mask j <= i
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = seg.masked_fill(~tri[None, None, :, :, None, None], -float("inf"))
    lmat = torch.exp(seg)
    xdt = xc * dtc[..., None]
    y = torch.einsum("bcgij,bcijgh,bcjghp->bcighp", cb,
                     lmat.to(x.dtype).to(f32), xdt.to(f32))

    # Chunk boundary states + inter-chunk recurrence.
    decay_out = torch.exp(cum[:, :, -1:] - cum)             # (B,nc,Q,G,Hg)
    states = torch.einsum("bcjgn,bcjghp->bcghnp", bc,
                          xdt * decay_out[..., None].to(x.dtype))
    chunk_decay = torch.exp(cum[:, :, -1])                  # (B,nc,G,Hg)

    ss = (torch.zeros((b, g, hg, n, p), dtype=x.dtype, device=x.device)
          if init_state is None else init_state)
    prev = []
    for i in range(nc):                                     # state BEFORE chunk
        prev.append(ss)
        ss = ss * chunk_decay[:, i, ..., None, None].to(ss.dtype) \
            + states[:, i]
    prev = torch.stack(prev, dim=1)                         # (B,nc,G,Hg,N,P)
    y_inter = torch.einsum("bcign,bcghnp->bcighp", cc, prev) \
        * torch.exp(cum).to(x.dtype)[..., None]
    # y accumulated in f32 via the cb einsum; back to the compute dtype
    y = (y + y_inter).to(x.dtype).reshape(b, l, g, hg, p)[:, :l0]
    return y, ss


def ssd_recurrent(cfg: ModelConfig, x, bm, c, dt, a_head, init_state=None):
    """Step-by-step recurrence (decode oracle; also the 1-token path)."""
    b, l = dt.shape[:2]
    x, bm, c, dt = _split_heads(cfg, x, bm, c, dt)
    g, hg = x.shape[2], x.shape[3]
    n, p = bm.shape[-1], x.shape[-1]
    a = dt * a_head.reshape(1, 1, g, hg)

    ss = (torch.zeros((b, g, hg, n, p), dtype=x.dtype, device=x.device)
          if init_state is None else init_state)
    ys = []
    f32 = torch.float32                # each step's update rounded once
    for t in range(l):
        ss = (ss.to(f32) * torch.exp(a[:, t].to(f32))[..., None, None]
              + torch.einsum("bgn,bghp->bghnp", bm[:, t].to(f32),
                             x[:, t].to(f32) * dt[:, t, ..., None].to(f32))
              ).to(ss.dtype)
        ys.append(torch.einsum("bgn,bghnp->bghp", c[:, t], ss))
    return torch.stack(ys, dim=1), ss


def _ssd(cfg: ModelConfig, fn, xh, br, cr, dt, a_head, d_skip, init):
    """The scan `fn` with its D skip: (y (B, L, H*P), final state)."""
    b, l, h = xh.shape[:3]
    y, new_state = fn(cfg, xh, br, cr, dt, a_head, init_state=init)
    dmat = d_skip.reshape(1, 1, cfg.ssm_groups, h // cfg.ssm_groups, 1)
    y = y + dmat * xh.reshape(y.shape)
    return y.reshape(b, l, h * xh.shape[3]), new_state


def _ssd_on_shards(cfg: ModelConfig, fn, xh, br, cr, dt, a_head, d_skip,
                   init, *, ctx: ShardCtx):
    """`_ssd` of DTensors on each rank's shards: the scan is local to a
    (batch, head) shard, its einsums flatten batch and head dims that
    DTensor cannot flatten when both are sharded. The heads are sharded
    over the model axis where it divides them and there is one group
    (B and C are shared by a group's heads, replicated here)."""
    # lint: disable=HS002,TS004 — a group and head count are host ints
    heads = "tp" if cfg.ssm_groups == 1 and model_axis_divides(
        xh, xh.shape[2], ctx) else None
    xh = ctx.constrain(xh, "dp", None, heads, None)
    br, cr = (ctx.constrain(t, "dp", None, None) for t in (br, cr))
    dt = ctx.constrain(dt, "dp", None, heads)
    a_head, d_skip = (ctx.constrain(t, heads) for t in (a_head, d_skip))
    if init is not None:
        init = local(ctx.constrain(replicated_like(init, xh), "dp", None,
                                   heads, None, None))
    y, state = _ssd(cfg, fn, local(xh), *(local(t, over=xh) for t in (
        br, cr, dt, a_head, d_skip)), init)
    return (from_shards(y, [(xh, {0: 0, 2: 2})]),
            from_shards(state, [(xh, {0: 0, 2: 2})]))


def ssm_block_apply(cfg: ModelConfig, p, h, *, ctx: ShardCtx = NO_SHARD,
                    cache=None, mode="train"):
    """One Mamba2 block. cache = (conv_x, conv_B, conv_C, ssm_state)."""
    x_in = apply_norm(cfg, h, p["norm"])
    z = x_in @ p["wz"]
    xr = x_in @ p["wx"]
    br = x_in @ p["wB"]
    cr = x_in @ p["wC"]
    dt_raw = x_in @ p["wdt"]

    cc = cache if cache is not None else (None, None, None, None)
    xr, ncx = _causal_conv(xr, p["conv_x"], p["conv_bias_x"], cc[0])
    br, ncb = _causal_conv(br, p["conv_B"], p["conv_bias_B"], cc[1])
    cr, ncc = _causal_conv(cr, p["conv_C"], p["conv_bias_C"], cc[2])

    b, l = xr.shape[:2]
    pre = dt_raw.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre)).to(xr.dtype)  # softplus
    a_head = -torch.exp(p["A_log"]).to(xr.dtype)
    xh = xr.reshape(b, l, cfg.ssm_heads, cfg.ssm_head_dim)

    use_recurrent = (mode == "decode") or l == 1
    fn = ssd_recurrent if use_recurrent else ssd_chunked
    args = (xh, br, cr, dt, a_head, p["D"].to(xr.dtype), cc[3])
    if is_dtensor(xh):
        y, new_state = _ssd_on_shards(cfg, fn, *args, ctx=ctx)
    else:
        y, new_state = _ssd(cfg, fn, *args)
    y = rms_norm(y * F.silu(z), p["gate_norm"])
    out = (y @ p["wo"]).to(h.dtype)
    new_cache = (ncx, ncb, ncc, new_state)
    return ctx.constrain(h + out, "dp", None, None), new_cache


# --------------------------------------------------------------------------
# Mamba2 LM (loss / prefill / decode)
# --------------------------------------------------------------------------


def _scan_blocks(cfg, layers, h, ctx, cache, mode):
    """Run the Mamba2 block stack over `layers`, a list of per-layer
    parameter trees (`layers.unstack`). In train mode no cache flows
    through and each block is rematerialized under cfg.remat;
    prefill/decode emit the per-layer conv histories + SSM states,
    stacked (L, ...)."""
    nl = len(layers)
    if mode == "train":
        for lp in layers:
            h, _ = remat(cfg, functools.partial(
                ssm_block_apply, cfg, ctx=ctx, mode=mode), lp, h)
        return h, None
    # prefill: fresh histories and states, zeros that each block makes
    # (the conv's history, the scan's initial state) for its layer only
    caches = unstack(cache) if cache is not None else [None] * nl
    new = []
    for lp, lc in zip(layers, caches):
        h, nc = ssm_block_apply(cfg, lp, h, ctx=ctx, cache=lc, mode=mode)
        new.append(nc)
    return h, tuple(torch.stack(parts) for parts in zip(*new))


def mamba_lm_apply(cfg: ModelConfig, params, tokens, *,
                   ctx: ShardCtx = NO_SHARD, cache=None, mode="train"):
    h = embed_tokens(params["embed"], tokens, cfg.adtype)
    h = ctx.constrain(h, "dp", None, None)
    h, new_cache = _scan_blocks(cfg, unstack(params["blocks"]), h, ctx,
                                cache, mode)
    h = apply_norm(cfg, h, params["final_norm"])
    logits = logits_out(cfg, params, h, ctx)
    return logits, new_cache


def mamba_lm_loss(cfg, params, batch, *, ctx: ShardCtx = NO_SHARD):
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    if cfg.ce_chunk:
        h = embed_tokens(params["embed"], inp, cfg.adtype)
        h = ctx.constrain(h, "dp", None, None)
        h, _ = _scan_blocks(cfg, unstack(params["blocks"]), h, ctx, None,
                            "train")
        h = apply_norm(cfg, h, params["final_norm"])
        loss = fused_cross_entropy(cfg, params, h, labels, ctx)
        return loss, {"loss": loss}
    logits, _ = mamba_lm_apply(cfg, params, inp, ctx=ctx)
    loss = cross_entropy(logits, labels, ctx=ctx)
    return loss, {"loss": loss}


def mamba_cache_shape(cfg: ModelConfig, batch: int):
    """Decode cache meta tensors (conv histories + SSM state)."""
    k = cfg.ssm_conv - 1
    g, hg = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups
    dt = cfg.adtype
    l = cfg.n_layers
    return (
        meta((l, batch, k, cfg.d_inner), dt),
        meta((l, batch, k, cfg.ssm_groups * cfg.ssm_state), dt),
        meta((l, batch, k, cfg.ssm_groups * cfg.ssm_state), dt),
        meta((l, batch, g, hg, cfg.ssm_state, cfg.ssm_head_dim), dt),
    )


def mamba_cache_logical(cfg: ModelConfig):
    return (
        ("layers", "batch", None, "ssm_inner"),
        ("layers", "batch", None, "state"),
        ("layers", "batch", None, "state"),
        ("layers", "batch", None, "ssm_heads", "state", "head_dim"),
    )


# --------------------------------------------------------------------------
# Zamba2 hybrid
# --------------------------------------------------------------------------


def _num_shared(cfg: ModelConfig) -> int:
    return max(1, cfg.n_layers // max(cfg.attn_every, 1))


def zamba_decls(cfg: ModelConfig):
    d = cfg.d_model
    ns = _num_shared(cfg)
    tree = {
        "embed": embed_init((cfg.vocab, d), ("vocab", "embed"), cfg.pdtype),
        "blocks": ssm_block_decls(cfg, layers=cfg.n_layers),
        "shared": {
            "w_in": dense_init((2 * d, d), ("embed", "embed2"), cfg.pdtype,
                               fan_in=2 * d),
            "attn_norm": norm_init(cfg, (d,), ("embed",)),
            "attn": attn_init(cfg),
            "mlp_norm": norm_init(cfg, (d,), ("embed",)),
            "mlp": mlp_init(cfg),
            "w_out": dense_init((ns, d, d), ("layers", "embed", "embed2"),
                                cfg.pdtype, fan_in=d),
        },
        "final_norm": norm_init(cfg, (d,), ("embed",)),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init((d, cfg.vocab), ("embed", "vocab"),
                                     cfg.pdtype, fan_in=d)
    return tree


def _shared_block(cfg, sp, use_idx, h, h0, positions, ctx,
                  kv=None, start=0, mode="train"):
    """The weight-shared transformer block, applied at `use_idx`. In
    decode, `kv` is this use's slice of the cache, written in place."""
    u = torch.cat([h, h0], dim=-1) @ sp["w_in"]
    a_in = apply_norm(cfg, u, sp["attn_norm"])
    q, k, v = attn_qkv(cfg, sp["attn"], a_in, positions, ctx=ctx)
    if mode == "decode":
        kc = cache_write(kv[0], k, start)
        vc = cache_write(kv[1], v, start)
        kv_len = (start + q.shape[1]).expand(h.shape[0])
        out = attention(cfg, q, kc, vc, positions, kv_len=kv_len,
                        causal=True, ctx=ctx)
        new_kv = (kc, vc)
    else:
        out = attention(cfg, q, k, v, positions, causal=True, ctx=ctx)
        new_kv = (k, v)
    u = u + attn_out(sp["attn"], out, ctx).to(u.dtype)
    u = u + mlp_apply(cfg, sp["mlp"], apply_norm(cfg, u, sp["mlp_norm"]), ctx)
    return h + u @ sp["w_out"][use_idx], new_kv


def zamba_apply(cfg: ModelConfig, params, tokens, *, ctx: ShardCtx = NO_SHARD,
                cache=None, mode="train", cache_len: int = 0):
    """cache = {"ssm": mamba caches, "kv": (k, v) stacked (ns, ...), "pos"}.

    In decode the returned cache's "kv" is the input cache's, written in
    place (the caller guarantees pos + S <= cache_len)."""
    b, s = tokens.shape
    ns = _num_shared(cfg)
    every = max(cfg.attn_every, 1)
    start = cache["pos"] if mode == "decode" else 0
    positions = positions_from(start, tokens)

    h = embed_tokens(params["embed"], tokens, cfg.adtype)
    h = ctx.constrain(h, "dp", None, None)
    h0 = h

    ssm_cache = cache["ssm"] if cache is not None else None
    layers = unstack(params["blocks"])
    new_ssm, new_kv_k, new_kv_v = [], [], []
    use = 0
    for seg0 in range(0, cfg.n_layers, every):
        seg1 = min(seg0 + every, cfg.n_layers)
        seg_cache = (tuple(x[seg0:seg1] for x in ssm_cache)
                     if ssm_cache is not None else None)
        h, seg_new = _scan_blocks(cfg, layers[seg0:seg1], h, ctx, seg_cache,
                                  mode)
        new_ssm.append(seg_new)
        if use < ns:
            kv = None
            if mode == "decode":
                kv = (cache["kv"][0][use], cache["kv"][1][use])
            h, nkv = _shared_block(cfg, params["shared"], use, h, h0,
                                   positions, ctx, kv=kv, start=start,
                                   mode=mode)
            if mode == "prefill" and cache_len:
                nkv = tuple(pad_seq(t, cache_len, dim=1) for t in nkv)
            new_kv_k.append(nkv[0])
            new_kv_v.append(nkv[1])
            use += 1

    h = apply_norm(cfg, h, params["final_norm"])
    logits = logits_out(cfg, params, h, ctx)
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {
            "ssm": tuple(torch.cat(parts, 0) for parts in zip(*new_ssm)),
            "kv": (cache["kv"] if mode == "decode"
                   else (torch.stack(new_kv_k), torch.stack(new_kv_v))),
            "pos": (start + s if mode == "decode"
                    else position_scalar(s, tokens.device)),
        }
    return logits, new_cache


def zamba_loss(cfg, params, batch, *, ctx: ShardCtx = NO_SHARD):
    tokens = batch["tokens"]
    logits, _ = zamba_apply(cfg, params, tokens[:, :-1], ctx=ctx)
    loss = cross_entropy(logits, tokens[:, 1:], ctx=ctx)
    return loss, {"loss": loss}


def zamba_cache_shape(cfg: ModelConfig, batch: int, cache_len: int):
    ns = _num_shared(cfg)
    kv = (ns, batch, cache_len, cfg.kv_heads, cfg.hd)
    return {
        "ssm": mamba_cache_shape(cfg, batch),
        "kv": (meta(kv, cfg.adtype), meta(kv, cfg.adtype)),
        "pos": meta((), torch.int32),
    }


def zamba_cache_logical(cfg: ModelConfig):
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"ssm": mamba_cache_logical(cfg), "kv": (kv, kv), "pos": ()}

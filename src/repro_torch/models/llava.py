"""LLaVA-NeXT-style VLM: Mistral-7B backbone + stubbed vision frontend.

The modality frontend is a STUB: `input_specs` provides precomputed
anyres patch embeddings (B, n_patches, vision_dim); here they pass through
the 2-layer MLP projector and are prepended to the token embeddings,
exactly as the real model splices projected CLIP features into the input
sequence. The backbone is the shared decoder-only transformer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tf
from repro_torch.models.config import NO_SHARD, ModelConfig, ShardCtx
from repro_torch.models.layers import (
    apply_norm, cross_entropy, dense_init, embed_tokens, logits_out)


def llava_decls(cfg: ModelConfig):
    tree = tf.lm_decls(cfg)
    tree["projector"] = {
        "w1": dense_init((cfg.vision_dim, cfg.d_model), ("vision", "embed"),
                         cfg.pdtype, fan_in=cfg.vision_dim),
        "w2": dense_init((cfg.d_model, cfg.d_model), ("embed", "embed2"),
                         cfg.pdtype, fan_in=cfg.d_model),
    }
    return tree


def _project(cfg, params, patches):
    h = patches.to(cfg.adtype) @ params["projector"]["w1"]
    return F.gelu(h, approximate="tanh") @ params["projector"]["w2"]


def _spliced(cfg, params, tokens, patches, ctx):
    """[projected patches; token embeddings] (B, P + S_text, D) and its
    positions."""
    img = _project(cfg, params, patches)                     # (B, P, D)
    txt = embed_tokens(params["embed"], tokens, cfg.adtype)  # (B, S, D)
    h = ctx.constrain(torch.cat([img, txt], dim=1), "dp", None, None)
    b, s = h.shape[:2]
    return h, tf.positions_from(0, b, s, h.device)


def llava_apply(cfg: ModelConfig, params, tokens, patches, *,
                ctx: ShardCtx = NO_SHARD):
    """tokens (B, S_text), patches (B, n_patches, vision_dim).

    Returns logits over the FULL spliced sequence (img tokens first)."""
    h, positions = _spliced(cfg, params, tokens, patches, ctx)
    h, aux, _ = tf.forward_hidden(cfg, params, h, positions, ctx=ctx)
    h = apply_norm(cfg, h, params["final_norm"])
    return logits_out(cfg, params, h, ctx), aux


def llava_loss(cfg, params, batch, *, ctx: ShardCtx = NO_SHARD):
    """CE over text positions only (image positions carry no labels)."""
    tokens = batch["tokens"]          # (B, S_text + 1)
    patches = batch["patches"]
    logits, aux = llava_apply(cfg, params, tokens[:, :-1], patches, ctx=ctx)
    n_img = patches.shape[1]
    txt_logits = logits[:, n_img:]
    loss = cross_entropy(txt_logits, tokens[:, 1:])
    return loss + cfg.aux_loss_coef * aux, {"loss": loss}


def llava_prefill(cfg, params, tokens, patches, *, cache_len: int,
                  ctx: ShardCtx = NO_SHARD):
    """Prefill the spliced [img; text] sequence, return cache for decode."""
    h, positions = _spliced(cfg, params, tokens, patches, ctx)
    h, _, (k, v) = tf.forward_hidden(cfg, params, h, positions, ctx=ctx,
                                     mode="prefill")
    h = apply_norm(cfg, h, params["final_norm"])
    logits = logits_out(cfg, params, h, ctx)
    return logits, {"k": tf.pad_seq(k, cache_len),
                    "v": tf.pad_seq(v, cache_len),
                    "pos": tf.position_scalar(h.shape[1], h.device)}


# decode after the spliced prefill is identical to the plain LM decode
llava_decode = tf.lm_decode

"""Unified model API: family dispatch + assigned input-shape definitions.

`Model(cfg)` exposes, uniformly across the 6 families:
  decls()                       declarative param tree (no allocation)
  loss(params, batch, ctx)      training loss + metrics (forward)
  prefill(params, batch, ctx)   prompt -> (logits, cache)
  decode(params, batch, ctx)    one token + cache -> (logits, cache)
  input_specs(shape)            meta-tensor batch for a ShapeSpec
  input_logical(shape)          logical axes for those inputs
  supports(shape)               assignment skip rules (long_500k etc.)

A model is a function of its parameter tree (`layers.materialize`, or
`layers.params_from_numpy` for the reference's weights). `prefill`
allocates the cache on its `device` (CUDA unless "cpu" is asked), where
the batch and the parameters must already be (it refuses them
elsewhere). `decode` reads nothing to the host; its returned cache
shares storage with the one passed in (the K/V are written in place),
and it requires pos + S <= cache_len.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.api import resolve_device
from repro_torch.models import llava as lv
from repro_torch.models import mamba2 as mb
from repro_torch.models import transformer as tf
from repro_torch.models import whisper as wh
from repro_torch.models.config import NO_SHARD, ModelConfig, ShardCtx
from repro_torch.models.layers import meta, tree_leaves


def on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether `t` lies on `dev` ("cuda" with no index takes any card)."""
    return t.device.type == dev.type and (
        dev.index is None or t.device.index == dev.index)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

TOK = ("batch", "seq")


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.family = cfg.family

    # ---------------- params ----------------

    def decls(self):
        c = self.cfg
        if self.family in ("dense", "moe"):
            return tf.lm_decls(c)
        if self.family == "ssm":
            return mb.mamba_lm_decls(c)
        if self.family == "hybrid":
            return mb.zamba_decls(c)
        if self.family == "encdec":
            return wh.whisper_decls(c)
        if self.family == "vlm":
            return lv.llava_decls(c)
        raise ValueError(self.family)

    # ---------------- steps ----------------

    def loss(self, params, batch, ctx: ShardCtx = NO_SHARD):
        c = self.cfg
        if self.family in ("dense", "moe"):
            return tf.lm_loss(c, params, batch, ctx=ctx)
        if self.family == "ssm":
            return mb.mamba_lm_loss(c, params, batch, ctx=ctx)
        if self.family == "hybrid":
            return mb.zamba_loss(c, params, batch, ctx=ctx)
        if self.family == "encdec":
            return wh.whisper_loss(c, params, batch, ctx=ctx)
        if self.family == "vlm":
            return lv.llava_loss(c, params, batch, ctx=ctx)
        raise ValueError(self.family)

    def prefill(self, params, batch, ctx: ShardCtx = NO_SHARD,
                cache_len: int = 0, *, device=None):
        """Prompt -> (logits, cache) on `device` (CUDA unless "cpu" is
        asked), where the batch and the parameters must lie: a tensor
        elsewhere raises ValueError."""
        c = self.cfg
        dev = resolve_device(device)
        for what, tree in (("batch", batch), ("params", params)):
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor) and not on_device(t, dev):
                    raise ValueError(
                        f"Model.prefill runs on {dev}, but its {what} holds "
                        f"a tensor on {t.device}: move the batch and the "
                        f"parameters there, or pass device={t.device.type!r}")
        cache_len = cache_len or batch["tokens"].shape[1]
        if self.family in ("dense", "moe"):
            return tf.lm_prefill(c, params, batch["tokens"],
                                 cache_len=cache_len, ctx=ctx)
        if self.family == "ssm":
            return mb.mamba_lm_apply(c, params, batch["tokens"], ctx=ctx,
                                     mode="prefill")
        if self.family == "hybrid":
            return mb.zamba_apply(c, params, batch["tokens"], ctx=ctx,
                                  mode="prefill", cache_len=cache_len)
        if self.family == "encdec":
            return wh.whisper_prefill(c, params, batch["frames"],
                                      batch["tokens"], cache_len=cache_len,
                                      ctx=ctx)
        if self.family == "vlm":
            return lv.llava_prefill(c, params, batch["tokens"],
                                    batch["patches"], cache_len=cache_len,
                                    ctx=ctx)
        raise ValueError(self.family)

    def decode(self, params, batch, ctx: ShardCtx = NO_SHARD):
        """tokens (B, S) + cache -> (logits, cache): no host read; the
        returned cache shares storage with batch["cache"]."""
        c = self.cfg
        tokens, cache = batch["tokens"], batch["cache"]
        if self.family in ("dense", "moe", "vlm"):
            return tf.lm_decode(c, params, tokens, cache, ctx=ctx)
        if self.family == "ssm":
            return mb.mamba_lm_apply(c, params, tokens, ctx=ctx,
                                     cache=cache, mode="decode")
        if self.family == "hybrid":
            return mb.zamba_apply(c, params, tokens, ctx=ctx, cache=cache,
                                  mode="decode")
        if self.family == "encdec":
            return wh.whisper_decode(c, params, tokens, cache, ctx=ctx)
        raise ValueError(self.family)

    # ---------------- shape support / input specs ----------------

    def supports(self, shape: ShapeSpec) -> bool:
        # long_500k needs sub-quadratic mixing; skipped for full attention.
        if shape.seq_len > 100_000 and not self.cfg.is_subquadratic():
            return False
        return True

    def skip_reason(self, shape: ShapeSpec) -> str:
        if self.supports(shape):
            return ""
        return ("full quadratic attention at seq 524288 is excluded by "
                "design (assignment: run long_500k only for SSM/hybrid)")

    def _cache_specs(self, batch: int, cache_len: int):
        c = self.cfg
        if self.family in ("dense", "moe", "vlm"):
            return tf.kv_cache_shape(c, batch, cache_len), \
                tf.kv_cache_logical(c)
        if self.family == "ssm":
            return mb.mamba_cache_shape(c, batch), mb.mamba_cache_logical(c)
        if self.family == "hybrid":
            return mb.zamba_cache_shape(c, batch, cache_len), \
                mb.zamba_cache_logical(c)
        if self.family == "encdec":
            return wh.whisper_cache_shape(c, batch, cache_len), \
                wh.whisper_cache_logical(c)
        raise ValueError(self.family)

    def input_specs(self, shape: ShapeSpec):
        """The batch for `shape` as meta tensors (no allocation)."""
        c = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def tok(*shp):
            return meta(shp, torch.int32)

        if shape.kind in ("train", "prefill"):
            extra = 1 if shape.kind == "train" else 0
            if self.family == "encdec":
                return {"frames": meta((b, c.src_seq, c.d_model), c.adtype),
                        "tokens": tok(b, s + extra)}
            if self.family == "vlm":
                return {"tokens": tok(b, s - c.n_patches + extra),
                        "patches": meta((b, c.n_patches, c.vision_dim),
                                        c.adtype)}
            return {"tokens": tok(b, s + extra)}
        # decode: one new token against a cache of seq_len capacity
        cache, _ = self._cache_specs(b, s)
        return {"tokens": tok(b, 1), "cache": cache}

    def input_logical(self, shape: ShapeSpec):
        if shape.kind in ("train", "prefill"):
            if self.family == "encdec":
                return {"frames": ("batch", None, None), "tokens": TOK}
            if self.family == "vlm":
                return {"tokens": TOK, "patches": ("batch", None, None)}
            return {"tokens": TOK}
        _, cache_logical = self._cache_specs(shape.global_batch,
                                             shape.seq_len)
        return {"tokens": TOK, "cache": cache_logical}

"""Shared neural building blocks: norms, RoPE, GQA attention, MLP, embeds.

Conventions:
  - activations (B, S, D); attention heads (B, S, H, head_dim);
  - params are plain tensors in nested dicts; every init helper returns
    a `ParamDecl` (shape, logical axes, dtype, init) and `materialize`
    turns a tree of them into tensors (`decl_shapes` into meta tensors,
    so a 480B model costs nothing to describe);
  - softmax/norm statistics and attention scores accumulate in f32
    whatever the compute dtype: operands are cast to f32 where the
    reference asks XLA for an f32 result (`preferred_element_type`);
  - attention dispatches between a dense path (short kv) and a kv-chunked
    online-softmax path (long prefill) so that long contexts never
    materialize an O(S*T) score tensor;
  - training differentiates the same functions with autograd; a stacked
    leaf is unbound into its layers once (`unstack`), and `checkpointed`
    recomputes a block's activations in the backward (the reference's
    `jax.checkpoint`).

Plain PyTorch ops that mirror the reference's XLA ones; no fused kernel
(its masking and accumulation would differ from the reference's).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.api import resolve_device
from repro_torch.models.config import (NO_SHARD, ModelConfig, ShardCtx,
                                       dtype_name, mesh_axes, torch_dtype)

# --------------------------------------------------------------------------
# declarative param system
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple
    logical: tuple      # logical axis names, len == ndim
    dtype: str
    kind: str = "normal"  # normal | zeros | ones
    std: float = 0.02


def dense_init(shape, logical, dtype, fan_in=None, scale=1.0):
    fan_in = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
    return ParamDecl(tuple(shape), tuple(logical), dtype_name(dtype),
                     "normal", scale / np.sqrt(max(fan_in, 1)))


def embed_init(shape, logical, dtype):
    return ParamDecl(tuple(shape), tuple(logical), dtype_name(dtype),
                     "normal", 0.02)


def ones_init(shape, logical, dtype):
    return ParamDecl(tuple(shape), tuple(logical), dtype_name(dtype), "ones")


def zeros_init(shape, logical, dtype):
    return ParamDecl(tuple(shape), tuple(logical), dtype_name(dtype),
                     "zeros")


def tree_leaves(tree, is_leaf=None):
    """Leaves of a tree of dicts (sorted keys, as jax.tree orders them),
    tuples and lists (a `ParamDecl` is a leaf; `is_leaf` makes more)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [v for x in tree for v in tree_leaves(x, is_leaf)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    """`fn` on every leaf (anything but a dict, tuple or list; a
    `ParamDecl` too) of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def unstack(tree) -> list:
    """The per-layer trees of a tree stacked on a leading `layers` axis.

    Each leaf is unbound once (`Tensor.unbind(0)`: views, no copy), whose
    backward stacks the layers' grads in one allocation, as `lax.scan`
    stacks its gradients; taking t[i] of the stack per layer would add a
    zero-filled grad of the whole stack per layer instead."""
    if isinstance(tree, dict):
        cols = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    if isinstance(tree, (tuple, list)):
        cols = [unstack(v) for v in tree]
        return [type(tree)(c[i] for c in cols) for i in range(len(cols[0]))]
    return list(tree.unbind(0))


# Outputs that the "dots" policy saves: matmuls without batch dims (the
# reference's dots_with_no_batch_dims_saveable; einsums reach aten.bmm).
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpointed(fn, *args, policy: str = "nothing"):
    """fn(*args) with its activations recomputed in the backward (the
    reference's `jax.checkpoint`): "nothing" saves nothing inside fn,
    "dots" only the outputs of aten.mm / aten.addmm. The forward runs the
    same operations either way. Without autograd it is fn(*args)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif policy != "nothing":
        raise ValueError(f"remat_policy {policy!r}: nothing | dots")
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def remat(cfg: ModelConfig, fn, *args):
    """A block of the layer loop: checkpointed under `cfg.remat` with
    `cfg.remat_policy`, else fn(*args)."""
    if cfg.remat:
        return checkpointed(fn, *args, policy=cfg.remat_policy)
    return fn(*args)


def materialize(decls, seed: int = 0, *, device=None):
    """Decl tree -> param tree on `device` (CUDA unless "cpu" is asked).

    Leaf i (in `tree_leaves` order) draws from its own `torch.Generator`
    on the device, seeded with (seed, i): deterministic per leaf, as the
    reference's `fold_in` keys are, though the values differ from JAX's.
    Normal leaves are drawn in f32 and cast to the leaf's dtype."""
    dev = resolve_device(device)
    leaves = tree_leaves(decls)
    index = {id(d): i for i, d in enumerate(leaves)}

    def make(d):
        dt = torch_dtype(d.dtype)
        if d.kind == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.kind == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * (1 << 20) + index[id(d)])
        return (torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=dev) * d.std).to(dt)

    return tree_map(make, decls)


def meta(shape, dtype) -> torch.Tensor:
    """A meta tensor (shape and dtype, no storage): the port's
    ShapeDtypeStruct."""
    return torch.empty(shape, dtype=torch_dtype(dtype), device="meta")


def decl_shapes(decls):
    """Decl tree -> meta tensors of the same shapes and dtypes (no
    allocation)."""
    return tree_map(lambda d: meta(d.shape, d.dtype), decls)


def decl_logical(decls):
    """Decl tree -> logical-axes tree."""
    return tree_map(lambda d: d.logical, decls)


def param_count(decls) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(decls))


def params_from_numpy(tree, device=None):
    """The reference's parameter tree as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's tree of tensors on
    `device`, same keys, same stacked `layers` axis. bfloat16 leaves (dtype
    name "bfloat16") travel as their 16-bit patterns."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(np.array(a.view(np.uint16))).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    return tree_map(leaf, tree)


# --------------------------------------------------------------------------
# DTensor regions run on each rank's shards
# --------------------------------------------------------------------------


def is_dtensor(t) -> bool:
    """Whether t is a DTensor (it has a device mesh)."""
    return getattr(t, "device_mesh", None) is not None


def local(t, over=None):
    """A DTensor's local shard (differentiable), or t itself. `over`: the
    DTensor that splits the region's computation; where it is sharded
    and t is not (a weight, B and C shared by the heads), each rank's
    gradient for t is a partial sum, and is declared so."""
    if not is_dtensor(t):
        return t
    if over is None:
        return t.to_local()
    from torch.distributed.tensor import Partial
    grad = [Partial() if o.is_shard() and not p.is_shard() else p
            for p, o in zip(t.placements, over.placements)]
    return t.to_local(grad_placements=grad)


def from_shards(out, sources):
    """`out`, computed from each rank's local shards, as a DTensor over the
    sources' mesh. sources: (DTensor, {source dim: out dim}) pairs; per
    mesh dim, Shard(out dim) where the first source sharded there shards
    a mapped dim, Partial() where it shards an unmapped one (out summed
    over it: a contraction over a sharded dim), Replicate() where no
    source is sharded. The regions that use it hold computations local to
    a shard whose ops DTensor cannot place (bmm's flattened batch of a
    data-sharded and a model-sharded dim, an in-place cache write, a
    padded cache, a vocab-sharded lookup), and they spare DTensor the
    sharding propagation of every op inside."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = sources[0][0].device_mesh
    placed = []
    for i in range(mesh.ndim):
        p = Replicate()
        for src, dims in sources:
            sp = src.placements[i]
            # lint: disable=HS002,TS004 — placements are host metadata
            if sp.is_shard():
                p = Shard(dims[sp.dim]) if sp.dim in dims else Partial()
                break
        placed.append(p)
    return DTensor.from_local(out, mesh, placed, run_check=False)


def replicated_like(t, ref):
    """t as a DTensor over ref's mesh: itself if it is one, else
    replicated (a tensor model code made from nothing, such as a fresh
    zero state)."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def model_axis_divides(t, n: int, ctx: ShardCtx) -> bool:
    """Whether t's mesh's model axis divides n (True for a plain tensor)."""
    mesh = getattr(t, "device_mesh", None)
    return mesh is None or n % mesh_axes(mesh).get(ctx.tp, 1) == 0


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def apply_norm(cfg: ModelConfig, x, p):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def norm_init(cfg: ModelConfig, shape, logical):
    p = {"scale": ones_init(shape, logical, cfg.pdtype)}
    if cfg.norm == "layernorm":
        p["bias"] = zeros_init(shape, logical, cfg.pdtype)
    return p


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Apply RoPE to x (B, S, H, D) at positions pos (B, S).

    fraction < 1 rotates only the leading `fraction * D` dims (rounded to a
    multiple of 2) and passes the rest through — the ChatGLM "2d"/partial
    RoPE variant uses fraction = 0.5.
    """
    d = x.shape[-1]
    rd = int(d * fraction) // 2 * 2
    if rd == 0:
        return x
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, rd, 2, dtype=torch.float32, device=x.device) / rd)
    ang = pos.to(torch.float32)[..., None] * freqs      # (B, S, rd/2)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    x1 = x[..., : rd // 2]
    x2 = x[..., rd // 2: rd]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rotated, x[..., rd:]], dim=-1)


def rope_fraction(cfg: ModelConfig) -> float:
    return {"full": 1.0, "half": 0.5, "none": 0.0}[cfg.rope]


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _grouped(q, hk):
    b, s, hq, d = q.shape
    return q.reshape(b, s, hk, hq // hk, d)


def _f32(*ts):
    return tuple(t.to(torch.float32) for t in ts)


def _dense_attention(q, k, v, q_pos, k_pos, kv_len, causal):
    """Materialized-scores path (short kv / decode)."""
    d = q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", *_f32(q, k))
    scores = scores * (1.0 / np.sqrt(d))
    mask = k_pos[:, None, :] < kv_len[:, None, None]
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _chunked_attention(q, k, v, q_pos, k_pos, kv_len, causal, chunk):
    """KV-chunked online-softmax (flash-style) path for long contexts: a
    loop over the KV chunks (the tail padded, its positions 2**30)."""
    b, s, hk, g, d = q.shape
    t = k.shape[1]
    pad = (-t) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2 ** 30)
    scale = 1.0 / np.sqrt(d)
    q32 = q.to(torch.float32)
    m = torch.full((b, hk, g, s), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hk, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, s, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kpc = k_pos[:, c0:c0 + chunk]
        sc = torch.einsum("bskgd,btkd->bkgst", q32,
                          kc.to(torch.float32)) * scale
        mask = kpc[:, None, :] < kv_len[:, None, None]
        if causal:
            mask = mask & (kpc[:, None, :] <= q_pos[:, :, None])
        sc = torch.where(mask[:, None, None], sc, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # accumulator stays f32 (flash-attention convention)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(q.dtype).to(torch.float32),
            vc.to(torch.float32))
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4)  # (B, S, Hk, g, d)


def attention(cfg: ModelConfig, q, k, v, q_pos, kv_len=None, *,
              causal=True, ctx: ShardCtx = NO_SHARD):
    """GQA attention. q (B,S,Hq,D); k/v (B,T,Hk,D); q_pos (B,S) absolute.

    kv_len (B,) masks cache positions >= kv_len (decode); defaults to T.
    DTensors run `_attention_on_shards`.
    """
    if is_dtensor(q):
        return _attention_on_shards(cfg, q, k, v, q_pos, kv_len, causal, ctx)
    return _attention(cfg, q, k, v, q_pos, kv_len, causal)


def _attention_on_shards(cfg, q, k, v, q_pos, kv_len, causal, ctx):
    """Attention of DTensors on each rank's shards. It is local to a
    (batch, head) shard, but its einsums flatten the batch and head dims
    into one for bmm, which DTensor refuses (or splits into a strided
    shard) when both are sharded. So q, k, v, the positions and kv_len
    are constrained to the batch axes, the heads placed as below, and
    `_attention` runs on the local tensors; its output is q's placements.

    Where the model axis divides the kv heads, q, k and v are sharded
    over it by head. Where it divides q's heads only (GQA with fewer kv
    heads than model ranks: 32 / 8 on 16), q is, and k and v stay
    replicated there: each rank takes the kv heads its own q heads read
    (its q heads hold whole kv groups, or lie in one), and its gradient
    for k and v is a partial sum over the model axis. Otherwise all
    three are replicated over it (56 heads on 16 ranks)."""
    mesh = q.device_mesh
    m = mesh_axes(mesh).get(ctx.tp, 1)
    hq, hk = q.shape[2], k.shape[2]
    per, group = hq // m, hq // hk
    sliced = hk % m != 0 and hq % m == 0 and (
        per % group == 0 or group % per == 0)
    # lint: disable=HS002,TS004 — head counts are host ints
    heads = "tp" if hk % m == 0 else None
    # lint: disable=HS002,TS004 — as above
    q = ctx.constrain(q, "dp", None, "tp" if sliced else heads, None)
    k, v = (ctx.constrain(t, "dp", None, heads, None) for t in (k, v))
    q_pos = ctx.constrain(q_pos, "dp", None)
    if kv_len is not None:
        kv_len = local(ctx.constrain(replicated_like(kv_len, q), "dp"))
    kl, vl = local(k, over=q), local(v, over=q)
    # lint: disable=HS002,TS004 — as above
    if sliced:
        lo = mesh.get_local_rank(mesh.mesh_dim_names.index(ctx.tp)) * per \
            // group
        kl, vl = (t[:, :, lo:lo + max(1, per // group)] for t in (kl, vl))
    out = _attention(cfg, local(q), kl, vl, local(q_pos), kv_len, causal)
    out = from_shards(out, [(q, {0: 0, 2: 2})])
    return ctx.constrain(out, "dp", None, "tp", None)


def _attention(cfg: ModelConfig, q, k, v, q_pos, kv_len, causal):
    """`attention` of plain tensors: (B, S, Hq, D)."""
    b, s, hq, d = q.shape
    t = k.shape[1]
    hk = k.shape[2]
    qg = _grouped(q, hk)
    k_pos = torch.arange(t, device=q.device)[None].expand(b, t)
    if kv_len is None:
        kv_len = torch.full((b,), t, dtype=torch.int32, device=q.device)
    # Dense path when the per-head score block S*T is small (covers short
    # contexts AND single-token decode against long caches); kv-chunked
    # online softmax otherwise (long prefill).
    if s * t <= cfg.attn_dense_max ** 2:
        out = _dense_attention(qg, k, v, q_pos, k_pos, kv_len, causal)
    else:
        out = _chunked_attention(qg, k, v, q_pos, k_pos, kv_len, causal,
                                 cfg.attn_chunk)
    return out.reshape(b, s, hq, d)


# --------------------------------------------------------------------------
# attention block params / apply
# --------------------------------------------------------------------------


def attn_init(cfg: ModelConfig, layers: Optional[int] = None):
    """QKV/O projections, optionally stacked over a leading `layers` dim."""
    hq, hk, hd, d = cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.d_model
    lead = (layers,) if layers else ()
    llog = ("layers",) if layers else ()
    p = {
        "wq": dense_init(lead + (d, hq * hd), llog + ("embed", "heads"),
                         cfg.pdtype, fan_in=d),
        "wk": dense_init(lead + (d, hk * hd), llog + ("embed", "kv_heads"),
                         cfg.pdtype, fan_in=d),
        "wv": dense_init(lead + (d, hk * hd), llog + ("embed", "kv_heads"),
                         cfg.pdtype, fan_in=d),
        "wo": dense_init(lead + (hq * hd, d), llog + ("heads", "embed2"),
                         cfg.pdtype, fan_in=hq * hd,
                         scale=1.0 / np.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init(lead + (hq * hd,), llog + ("heads",), cfg.pdtype)
        p["bk"] = zeros_init(lead + (hk * hd,), llog + ("kv_heads",), cfg.pdtype)
        p["bv"] = zeros_init(lead + (hk * hd,), llog + ("kv_heads",), cfg.pdtype)
    return p


def split_heads(t, h: int, hd: int, ctx: ShardCtx = NO_SHARD):
    """(B, S, h*hd) -> (B, S, h, hd). A DTensor whose last dim is sharded
    over the model axis is gathered over it first when that axis does not
    divide h: DTensor splits a sharded dim evenly only (GSPMD would pad:
    56 heads to 64); the heads then run replicated over the model axis."""
    if not model_axis_divides(t, h, ctx):
        t = ctx.constrain(t, "dp", None, None)
    return t.reshape(t.shape[0], t.shape[1], h, hd)


def attn_qkv(cfg: ModelConfig, p, x, pos, *, use_rope=True,
             ctx: ShardCtx = NO_SHARD):
    """Project + (optionally) rotate. Returns q (B,S,Hq,hd), k/v (B,S,Hk,hd)."""
    hq, hk, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, hq, hd, ctx)
    k = split_heads(k, hk, hd, ctx)
    v = split_heads(v, hk, hd, ctx)
    if use_rope and cfg.rope != "none":
        fr = rope_fraction(cfg)
        q = rope(q, pos, cfg.rope_theta, fr)
        k = rope(k, pos, cfg.rope_theta, fr)
    return q, k, v


def attn_out(p, o, ctx: ShardCtx = NO_SHARD):
    """The output projection, its result constrained to the batch axes:
    a DTensor's head-sharded contraction leaves a partial sum, reduced
    here (Megatron's all-reduce after the row-parallel matmul); left
    partial, the norm after the residual add would make DTensor gather the
    next matmul's weight and run it on every model rank."""
    b, s = o.shape[:2]
    return ctx.constrain(o.reshape(b, s, -1) @ p["wo"], "dp", None, None)


def cache_write(cache, new, start):
    """Write `new` (B, S, ...) into `cache` (B, T, ...) at positions
    start + arange(S), in place, and return `cache`.

    `start` is a device scalar, so nothing is read to the host. The
    caller guarantees start + S <= T (the reference's
    dynamic_update_slice would clamp the start instead)."""
    idx = start.to(torch.int64) + torch.arange(new.shape[1],
                                               device=cache.device)
    if is_dtensor(cache):     # on each rank's shard, new placed as cache
        new = new.redistribute(cache.device_mesh, cache.placements)
        local(cache).index_copy_(1, local(idx), local(new).to(cache.dtype))
        return cache
    return cache.index_copy_(1, idx, new.to(cache.dtype))


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def mlp_init(cfg: ModelConfig, d_ff: Optional[int] = None,
             layers: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    lead = (layers,) if layers else ()
    llog = ("layers",) if layers else ()
    p = {"wu": dense_init(lead + (d, ff), llog + ("embed", "mlp"),
                          cfg.pdtype, fan_in=d),
         "wo": dense_init(lead + (ff, d), llog + ("mlp", "embed2"),
                          cfg.pdtype, fan_in=ff,
                          scale=1.0 / np.sqrt(2 * max(cfg.n_layers, 1)))}
    if cfg.act.endswith("_glu"):
        p["wg"] = dense_init(lead + (d, ff), llog + ("embed", "mlp"),
                             cfg.pdtype, fan_in=d)
    return p


def activate(act: str, gate, u):
    """The MLP's nonlinearity: silu(gate) u, gelu(gate) u or gelu(u)
    (GELU in its tanh form, the reference's approximate=True)."""
    f32 = torch.float32                # the chain in f32, rounded once
    if act == "silu_glu":
        return (F.silu(gate.to(f32)) * u.to(f32)).to(u.dtype)
    if act == "gelu_glu":
        return (F.gelu(gate.to(f32), approximate="tanh")
                * u.to(f32)).to(u.dtype)
    return F.gelu(u.to(f32), approximate="tanh").to(u.dtype)


def mlp_apply(cfg: ModelConfig, p, x, ctx: ShardCtx = NO_SHARD):
    u = x @ p["wu"]
    gate = x @ p["wg"] if cfg.act.endswith("_glu") else None
    h = ctx.constrain(activate(cfg.act, gate, u), "dp", None, "tp")
    return h @ p["wo"]


# --------------------------------------------------------------------------
# embeddings / logits / loss
# --------------------------------------------------------------------------


def embed_tokens(embed, tokens, dtype):
    """embed[tokens] in `dtype`; a DTensor table by `_embed_on_shards`."""
    if is_dtensor(embed):
        return _embed_on_shards(embed, tokens, dtype)
    return embed[tokens].to(dtype)


def _embed_on_shards(embed, tokens, dtype):
    """The lookup of a vocab-sharded table on each rank's shards (a
    vocab-parallel embedding): the table gathered over every mesh dim but
    the vocab's (an FSDP gather of its embed dim), the tokens over the
    vocab's; each rank looks up the ids in its own vocab range and zeroes
    the others, so the result is a partial sum over the vocab's mesh dims
    (the caller's `constrain` reduces it)."""
    from torch.distributed.tensor import Replicate
    mesh = embed.device_mesh
    vocab = [i for i, p in enumerate(embed.placements)
             if p.is_shard() and p.dim == 0]
    embed = embed.redistribute(mesh, [
        p if i in vocab else Replicate()
        for i, p in enumerate(embed.placements)])
    tokens = tokens.redistribute(mesh, [
        Replicate() if i in vocab else p
        for i, p in enumerate(tokens.placements)])
    table = local(embed, over=tokens)
    rows = table.shape[0]
    first = 0
    for i in vocab:           # this rank's first id (shards in mesh order)
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    ids = local(tokens).to(torch.int64) - first * rows
    hit = (ids >= 0) & (ids < rows)
    out = table[ids.clamp(0, rows - 1)] * hit[..., None].to(table.dtype)
    return from_shards(out.to(dtype), [(tokens, {0: 0, 1: 1}),
                                       (embed, {})])


def _out_table(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_out(cfg: ModelConfig, params, h, ctx: ShardCtx = NO_SHARD):
    logits = h @ _out_table(cfg, params).to(h.dtype)
    return ctx.constrain(logits, "dp", None, "tp")


class _Pick(torch.autograd.Function):
    """torch.gather(x, -1, idx) of (B, S, V) logits whose backward
    scatters the gradient into zeros made like x (autograd's own makes
    them with `new_zeros` of x's shape, which a DTensor replicates at the
    global shape) and constrains it back to x's batch and vocab axes (a
    DTensor scatters along an unsharded dim only): the same values."""

    @staticmethod
    def forward(ctx, x, idx, shard):
        ctx.save_for_backward(x, idx)
        ctx.shard = shard
        return torch.gather(x, -1, idx)

    @staticmethod
    def backward(ctx, grad):
        x, idx = ctx.saved_tensors
        gx = torch.zeros_like(x).scatter_add(-1, idx, grad)
        return ctx.shard.constrain(gx, "dp", None, "tp"), None, None


class _LogSumExp(torch.autograd.Function):
    """torch.logsumexp(x, -1) written out as ATen computes it (the same
    values, bitwise), with autograd's backward for it: DTensor has no rule
    that keeps a sharded last dim through logsumexp, but it reduces a
    sharded amax and sum (an all-reduce of the (B, S) statistics)."""

    @staticmethod
    def forward(ctx, x):
        m = torch.amax(x, -1, keepdim=True)
        m = m.masked_fill(m.abs() == math.inf, 0)
        out = torch.log(torch.sum((x - m).exp_(), -1)) + m[..., 0]
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad[..., None] * (x - out[..., None]).exp()


def _nll(logits, labels, ctx: ShardCtx = NO_SHARD):
    """(per-token nll, valid mask) in f32; labels < 0 are ignored. The
    label's logit is picked from the (vocab-sharded) logits and
    constrained to the batch axes before it drops its last dim: DTensor
    keeps a masked partial sum through the view otherwise, and cannot
    reduce it there."""
    logits = logits.to(torch.float32)
    lse = _LogSumExp.apply(logits)
    ll = _Pick.apply(logits, torch.clamp(labels, min=0)[..., None]
                     .to(torch.int64), ctx)
    ll = ctx.constrain(ll, "dp", None, None)[..., 0]
    return lse - ll, (labels >= 0).to(torch.float32)


def cross_entropy(logits, labels, mask=None, ctx: ShardCtx = NO_SHARD):
    """Token-mean CE in f32; labels < 0 are ignored."""
    nll, valid = _nll(logits, labels, ctx)
    if mask is not None:
        valid = valid * mask.to(torch.float32)
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _ce_chunk(ctx, hc, w, lc):
    logits = ctx.constrain(hc @ w.to(hc.dtype), "dp", None, "tp")
    nll, valid = _nll(logits, lc, ctx)
    return (nll * valid).sum(), valid.sum()


def fused_cross_entropy(cfg: ModelConfig, params, h, labels,
                        ctx: ShardCtx = NO_SHARD):
    """CE without materializing full (B, S, V) logits: a loop over
    sequence chunks of `ce_chunk`, each projecting h @ W and reducing to
    (nll_sum, count) under `checkpointed`, so the backward recomputes a
    chunk's logits too (the reference's `jax.checkpoint(step,
    nothing_saveable)`): peak logits memory B * ce_chunk * V.
    Equivalent to cross_entropy(logits_out(h), labels) up to summation
    order."""
    w = _out_table(cfg, params)
    s = h.shape[1]
    c = cfg.ce_chunk
    if not c or s % c:
        return cross_entropy(logits_out(cfg, params, h, ctx), labels,
                             ctx=ctx)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, c):
        part, n = checkpointed(_ce_chunk, ctx, h[:, c0:c0 + c], w,
                               labels[:, c0:c0 + c])
        nll_sum = nll_sum + part
        cnt = cnt + n
    return nll_sum / torch.clamp(cnt, min=1.0)

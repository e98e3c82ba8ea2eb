"""Model configuration + logical-axis sharding for the LM substrate.

Every parameter is created together with a tuple of *logical axis names*
(e.g. ("embed", "mlp")); the rule tables below map logical names to mesh
axes. Two built-in rule sets:

  - "tp":      Megatron tensor parallelism over the `model` axis, params
               replicated over `data`/`pod`, batch over (`pod`, `data`).
  - "fsdp_tp": additionally shards the `embed` logical axis over `data`
               (ZeRO-3-style 2D sharding; needed for the 480B MoE).

The tables are the reference's. `resolve_spec` and `make_shardings`
read only a mesh's axis names and sizes: a `torch.distributed`
`DeviceMesh` (``mesh_dim_names``, ``shape``), a `launch.mesh.MeshShape`
description, or anything else with those two attributes. They give per
leaf the tuple that the reference's `PartitionSpec` holds, with its
divisibility fallback. `ShardCtx.constrain` is the identity: the port
trains one process on one device, where a constraint changes nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the configs ("bfloat16", ...) as a torch.dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]


def dtype_name(dtype) -> str:
    """A torch.dtype (or a name) as the configs' name: "float32", ..."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return str(dtype)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 0       # 0 -> n_heads (MHA)
    head_dim: int = 0         # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 256
    act: str = "silu_glu"     # silu_glu | gelu_glu | gelu
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    rope: str = "full"        # full | half | none
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0     # parallel dense-MLP residual branch (arctic)
    capacity_factor: float = 1.25
    moe_group: int = 1024     # dispatch group size (tokens)
    aux_loss_coef: float = 0.01
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1
    attn_every: int = 0       # hybrid: shared attention block each k layers
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    src_seq: int = 1500       # post-conv-frontend audio frames (stub input)
    # --- VLM (llava) ---
    vision_dim: int = 0       # stub patch-embedding dim
    n_patches: int = 0
    # --- numerics / execution ---
    dtype: str = "float32"          # activation compute dtype
    param_dtype: str = "float32"
    remat: bool = True              # recompute each block in the backward
    remat_policy: str = "nothing"   # nothing | dots
    grad_accum: int = 1             # microbatches per step
    ce_chunk: int = 0               # fused CE seq-chunk; 0 = dense loss
    shard_residual: bool = False    # shard residual-stream D over `model`
    attn_chunk: int = 1024          # kv-chunked attention block size
    attn_dense_max: int = 8192      # use dense attention when T <= this

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")


# --------------------------------------------------------------------------
# Sharding rules
# --------------------------------------------------------------------------

Rules = Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...]

_COMMON = (
    ("batch", ("pod", "data")),
    ("seq", None),
    ("layers", None),
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("mlp", ("model",)),
    ("experts", ("model",)),
    ("ssm_heads", ("model",)),
    ("ssm_inner", ("model",)),
    ("conv_dim", None),
    ("head_dim", None),
    ("state", None),
    ("embed", None),
    ("embed2", None),   # second embed-sized axis (e.g. attn output proj)
    ("patches", None),
    ("vision", None),
    ("expert_mlp", None),
)

TP_RULES: Rules = _COMMON
FSDP_TP_RULES: Rules = tuple(
    (k, ("data",) if k in ("embed", "embed2") else v) for k, v in _COMMON)

RULE_SETS = {"tp": TP_RULES, "fsdp_tp": FSDP_TP_RULES}


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a mesh: its ``mesh_dim_names`` and ``shape``
    (a `DeviceMesh` or a `launch.mesh.MeshShape`)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def resolve_spec(logical, shape, rules: Rules, mesh) -> tuple:
    """Logical axes -> the entries of the reference's PartitionSpec (a
    mesh axis name, a tuple of them, or None per dim, trailing Nones
    dropped), with its divisibility fallback: a dim that the mesh axes'
    product does not divide is replicated (e.g. kv_heads=2 or vocab=49155
    on a 16-way model axis)."""
    table = dict(rules)
    axes = mesh_axes(mesh)
    used = set()
    out = []
    for ax_name, dim in zip(logical, shape):
        mesh_ax = table.get(ax_name) if ax_name else None
        if mesh_ax is None:
            out.append(None)
            continue
        mesh_ax = tuple(a for a in mesh_ax if a in axes and a not in used)
        size = math.prod(axes[a] for a in mesh_ax)
        if not mesh_ax or dim % size != 0:
            out.append(None)
            continue
        used.update(mesh_ax)
        out.append(mesh_ax if len(mesh_ax) > 1 else mesh_ax[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a resolved spec over `mesh`'s dims: Shard(d)
    for a mesh axis that spec entry d names, Replicate() otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def make_shardings(spec_tree, param_shapes, rules: Rules, mesh):
    """The resolved spec of every leaf of a (logical-axes tree, shapes
    tree) over `mesh`; where `mesh` is a `DeviceMesh` of more than one
    device, each leaf's DTensor placements over it instead."""
    devices = math.prod(mesh_axes(mesh).values())
    many = devices > 1 and hasattr(mesh, "get_group")

    def walk(logical, shp):
        if isinstance(logical, dict):
            return {k: walk(v, shp[k]) for k, v in logical.items()}
        if not _is_logical(logical):
            raise TypeError(f"not a logical-axes tuple: {logical!r}")
        spec = resolve_spec(logical, tuple(shp.shape), rules, mesh)
        return placements(spec, mesh) if many else spec

    return walk(spec_tree, param_shapes)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Static activation-sharding context threaded through model code.

    The port runs a model on one device, where a sharding constraint
    changes nothing: `constrain` and `batch` return their input, enabled
    or not."""

    enabled: bool = False
    dp: Tuple[str, ...] = ("pod", "data")   # batch axes present in the mesh
    tp: str = "model"

    def constrain(self, x, *axes):
        return x

    def batch(self, x):
        return x


NO_SHARD = ShardCtx(enabled=False)


def shard_ctx_for_mesh(mesh) -> ShardCtx:
    names = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    return ShardCtx(enabled=True, dp=dp, tp="model")

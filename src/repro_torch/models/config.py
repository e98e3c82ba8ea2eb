"""Model configuration + logical-axis sharding for the LM substrate.

Every parameter is created together with a tuple of *logical axis names*
(e.g. ("embed", "mlp")); the rule tables below map logical names to mesh
axes. Two built-in rule sets:

  - "tp":      Megatron tensor parallelism over the `model` axis, params
               replicated over `data`/`pod`, batch over (`pod`, `data`).
  - "fsdp_tp": additionally shards the `embed` logical axis over `data`
               (ZeRO-3-style 2D sharding; needed for the 480B MoE).

The tables are the reference's. Resolving them against a mesh needs the
port's mesh (`launch/mesh.py`), which comes with training: until then
`resolve_spec`, `make_shardings` and `shard_ctx_for_mesh` raise, and
`ShardCtx.constrain` is the identity (one device holds everything).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

#: Raised by what needs a device mesh (the port's mesh is not yet here).
MESH_LATER = "device meshes: ROADMAP queue A item 2"

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
    remat: bool = True              # (takes effect with the backward)
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


def resolve_spec(logical, shape, rules: Rules, mesh):
    """Logical axes -> a placement over `mesh` (needs the port's mesh)."""
    raise NotImplementedError(f"resolve_spec: {MESH_LATER}")


def make_shardings(spec_tree, param_shapes, rules: Rules, mesh):
    """Placements for a (logical-axes tree, shapes tree) over `mesh`."""
    raise NotImplementedError(f"make_shardings: {MESH_LATER}")


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Static activation-sharding context threaded through model code.

    The port runs a model on one device, where a sharding constraint
    changes nothing: `constrain` and `batch` return their input."""

    enabled: bool = False
    dp: Tuple[str, ...] = ("pod", "data")   # batch axes present in the mesh
    tp: str = "model"

    def constrain(self, x, *axes):
        return x

    def batch(self, x):
        return x


NO_SHARD = ShardCtx(enabled=False)


def shard_ctx_for_mesh(mesh) -> ShardCtx:
    raise NotImplementedError(f"shard_ctx_for_mesh: {MESH_LATER}")

"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) expert-ff 4864 v32000,
MoE 128e top-2 + dense residual MLP [hf:Snowflake/snowflake-arctic-base;
hf]. Trained with FSDP+TP sharding and Adafactor states (see
launch/dryrun.py) so params+optimizer fit 512 x 16 GB."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, act="silu_glu", norm="rmsnorm", rope="full",
    n_experts=128, top_k=2, moe_dense_ff=4864, capacity_factor=1.25,
    moe_group=1024, dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=48, vocab=128,
    act="silu_glu", norm="rmsnorm", rope="full",
    n_experts=8, top_k=2, moe_dense_ff=48, capacity_factor=1.5,
    moe_group=64, dtype="float32", param_dtype="float32", remat=False,
)

"""granite-moe-1b-a400m [moe]: 24L d1024 16H (GQA kv=8) expert-ff 512
v49155, 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, act="silu_glu", norm="rmsnorm", rope="full",
    n_experts=32, top_k=8, capacity_factor=1.25, moe_group=1024,
    tie_embeddings=True, dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab=128,
    act="silu_glu", norm="rmsnorm", rope="full",
    n_experts=4, top_k=2, capacity_factor=1.5, moe_group=64,
    tie_embeddings=True, dtype="float32", param_dtype="float32", remat=False,
)

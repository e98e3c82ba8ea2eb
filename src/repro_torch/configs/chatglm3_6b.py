"""chatglm3-6b [dense]: 28L d4096 32H (GQA kv=2) ff13696 v65024 — RoPE 2d,
GQA [arXiv:2406.12793; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, act="silu_glu", norm="rmsnorm", rope="half",
    qkv_bias=True, dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=128,
    act="silu_glu", norm="rmsnorm", rope="half", qkv_bias=True,
    dtype="float32", param_dtype="float32", remat=False,
)

"""stablelm-12b [dense]: 40L d5120 32H (GQA kv=8) ff13824 v100352
[hf:stabilityai/stablelm-2-12b; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, act="silu_glu", norm="layernorm", rope="full",
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke", family="dense",
    n_layers=2, d_model=80, n_heads=4, n_kv_heads=2, d_ff=192, vocab=160,
    act="silu_glu", norm="layernorm", rope="full",
    dtype="float32", param_dtype="float32", remat=False,
)

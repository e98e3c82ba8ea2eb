"""internlm2-1.8b [dense]: 24L d2048 16H (GQA kv=8) ff8192 v92544
[arXiv:2403.17297; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab=92544, act="silu_glu", norm="rmsnorm", rope="full",
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    act="silu_glu", norm="rmsnorm", rope="full",
    dtype="float32", param_dtype="float32", remat=False,
)

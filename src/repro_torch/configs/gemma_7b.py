"""gemma-7b [dense]: 28L d3072 16H (kv=16) ff24576 v256000 — GeGLU,
head_dim=256, tied embeddings [arXiv:2403.08295; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="gelu_glu", norm="rmsnorm", rope="full",
    tie_embeddings=True, dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
    vocab=256, act="gelu_glu", norm="rmsnorm", rope="full",
    tie_embeddings=True, dtype="float32", param_dtype="float32", remat=False,
)

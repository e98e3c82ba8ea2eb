"""zamba2-1.2b [hybrid]: 38L d2048 32H (kv=32) ff8192 v32000 ssm_state=64 —
Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, act="gelu_glu", norm="rmsnorm", rope="full",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    ssm_chunk=256, attn_every=6,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    act="gelu_glu", norm="rmsnorm", rope="full",
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv=4,
    ssm_chunk=16, attn_every=2,
    dtype="float32", param_dtype="float32", remat=False,
)

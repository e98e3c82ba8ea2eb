"""mamba2-1.3b [ssm]: 48L d2048 (attn-free) v50280 ssm_state=128 — SSD
state-space duality [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, d_ff=0, vocab=50280,
    norm="rmsnorm", rope="none",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    ssm_chunk=256, ssm_groups=1,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm",
    n_layers=3, d_model=64, d_ff=0, vocab=128, norm="rmsnorm", rope="none",
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv=4, ssm_chunk=16,
    dtype="float32", param_dtype="float32", remat=False,
)

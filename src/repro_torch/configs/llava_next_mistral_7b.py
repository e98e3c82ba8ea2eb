"""llava-next-mistral-7b [vlm]: 32L d4096 32H (GQA kv=8) ff14336 v32000 —
anyres tiling; vision frontend stubbed to precomputed patch embeddings
(B, 2880, 1024) = 5 tiles x 576 patches of CLIP-L/14 features
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, act="silu_glu", norm="rmsnorm", rope="full",
    vision_dim=1024, n_patches=2880,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    act="silu_glu", norm="rmsnorm", rope="full",
    vision_dim=24, n_patches=8,
    dtype="float32", param_dtype="float32", remat=False,
)

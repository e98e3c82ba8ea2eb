"""whisper-small [audio/encdec]: 12+12L d768 12H ff3072 v51865 — enc-dec,
conv frontend stubbed to precomputed frame embeddings
[arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, act="gelu", norm="layernorm", rope="none",
    src_seq=1500, dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, act="gelu", norm="layernorm", rope="none",
    src_seq=32, dtype="float32", param_dtype="float32", remat=False,
)

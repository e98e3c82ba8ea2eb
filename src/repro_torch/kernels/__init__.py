"""Hand-written CUDA kernels (sources under `csrc/`), their wrappers
with plain PyTorch versions, and the backend dispatch in `ops`."""

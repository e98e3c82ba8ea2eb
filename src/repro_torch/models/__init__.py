"""The LM skeleton: configs, layers, MoE, transformer, Mamba2/Zamba2,
Whisper, LLaVA and the `Model` API (serving: prefill and decode)."""

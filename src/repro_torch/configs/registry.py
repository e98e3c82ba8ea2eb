"""Architecture registry: --arch <id> -> ModelConfig (full or smoke)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "internlm2-1.8b": "internlm2_1_8b",
    "gemma-7b": "gemma_7b",
    "stablelm-12b": "stablelm_12b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-small": "whisper_small",
    "mamba2-1.3b": "mamba2_1_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "arctic-480b": "arctic_480b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.FULL


def rule_set_for(arch: str) -> str:
    """Param sharding rules: the 480B MoE needs FSDP+TP, the rest TP."""
    return "fsdp_tp" if arch == "arctic-480b" else "tp"


def optimizer_for(arch: str) -> str:
    """Adafactor for the 480B MoE (factored 2nd moment — params +
    optimizer states fit the pod); AdamW elsewhere."""
    return "adafactor" if arch == "arctic-480b" else "adamw"

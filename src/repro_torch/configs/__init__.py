"""Assigned-architecture registry: ``get_config(arch_id)`` / ``ARCHS``."""

from repro_torch.models.config import ModelConfig

from repro_torch.configs.granite_20b import CONFIG as granite_20b
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from repro_torch.configs.mamba2_780m import CONFIG as mamba2_780m
from repro_torch.configs.deepseek_v2_236b import CONFIG as deepseek_v2_236b
from repro_torch.configs.llama3_405b import CONFIG as llama3_405b
from repro_torch.configs.mistral_large_123b import CONFIG as mistral_large_123b
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.mistral_nemo_12b import CONFIG as mistral_nemo_12b
from repro_torch.configs.qwen2_vl_72b import CONFIG as qwen2_vl_72b
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium

ARCHS = {
    c.name: c
    for c in [
        granite_20b,
        qwen3_moe_30b_a3b,
        mamba2_780m,
        deepseek_v2_236b,
        llama3_405b,
        mistral_large_123b,
        zamba2_7b,
        mistral_nemo_12b,
        qwen2_vl_72b,
        whisper_medium,
    ]
}

# Sliding window used for long-context (524k) decode on archs whose
# attention is otherwise quadratic/full (DESIGN.md §4).
LONG_CONTEXT_WINDOW = 8192


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}"
        ) from None

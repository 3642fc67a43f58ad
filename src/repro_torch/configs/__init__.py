"""Config registry: ``--arch <id>`` -> ArchConfig (port of
``repro.configs``).

The port registers all ten of the JAX package's architectures: RWKV6,
Zamba2, the dense and VLM transformers, the MoE transformers (Qwen's,
and DeepSeek-V2's with MLA) and Whisper.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_236b, granite_3_2b, minitron_8b, paligemma_3b,
    qwen2_moe_a2_7b, rwkv6_1_6b, stablelm_3b, tinyllama_1_1b,
    whisper_medium, zamba2_2_7b,
)
from repro_torch.configs.base import ArchConfig, SHAPES, ShapeCfg, shape_supported

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (tinyllama_1_1b, minitron_8b, granite_3_2b, stablelm_3b,
              rwkv6_1_6b, whisper_medium, qwen2_moe_a2_7b,
              deepseek_v2_236b, paligemma_3b, zamba2_2_7b)
}

__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeCfg", "get_arch",
           "shape_supported"]


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; options: {sorted(ARCHS)}")
    return ARCHS[arch_id]

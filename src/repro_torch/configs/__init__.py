"""Config registry: ``--arch <id>`` -> ArchConfig (port of
``repro.configs``).

The port serves ``rwkv6-1.6b``, ``zamba2-2.7b``, the dense and VLM
transformers and ``qwen2-moe-a2.7b``; the JAX package's other
architectures are named here so that asking for one says which ROADMAP
item ports it.
"""
from __future__ import annotations

from repro_torch.configs import (
    granite_3_2b, minitron_8b, paligemma_3b, qwen2_moe_a2_7b, rwkv6_1_6b,
    stablelm_3b, tinyllama_1_1b, zamba2_2_7b,
)
from repro_torch.configs.base import ArchConfig, SHAPES, ShapeCfg, shape_supported

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (tinyllama_1_1b, minitron_8b, granite_3_2b, stablelm_3b,
              rwkv6_1_6b, qwen2_moe_a2_7b, paligemma_3b, zamba2_2_7b)
}

#: the JAX package's other architectures, not ported yet
NOT_PORTED: dict[str, str] = {
    "deepseek-v2-236b": "ROADMAP A.11 (MLA family)",
    "whisper-medium": "ROADMAP A.11 (Whisper family)",
}

__all__ = ["ARCHS", "ArchConfig", "NOT_PORTED", "SHAPES", "ShapeCfg",
           "get_arch", "shape_supported"]


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: "
                       f"{NOT_PORTED[arch_id]}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; options: {sorted(ARCHS)}")
    return ARCHS[arch_id]

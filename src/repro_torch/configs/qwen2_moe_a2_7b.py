"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts (padded to 64 on 16-way expert-parallel meshes; pad
experts are masked out of routing), top-4, d_ff_expert=1408; the 4
shared experts are fused into one always-on MLP of width 4*1408=5632.
The same numbers as ``repro.configs.qwen2_moe_a2_7b``.
"""
from repro_torch.configs.base import ArchConfig, Family, MoECfg

CONFIG = ArchConfig(
    arch_id="qwen2-moe-a2.7b",
    family=Family.MOE,
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, act="silu",
    moe=MoECfg(n_experts=60, top_k=4, d_ff_expert=1408,
               n_shared=4, d_ff_shared=5632),
    supports_long=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

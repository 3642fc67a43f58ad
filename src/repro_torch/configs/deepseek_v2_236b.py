"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2].

MLA: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128,
128 heads.  MoE: 160 routed top-6 (d_ff 1536) + 2 shared, first layer
dense (d_ff 12288).  The same numbers as
``repro.configs.deepseek_v2_236b``.
"""
from repro_torch.configs.base import ArchConfig, Family, MLACfg, MoECfg

CONFIG = ArchConfig(
    arch_id="deepseek-v2-236b",
    family=Family.MOE,
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, act="silu",
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512,
               qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(n_experts=160, top_k=6, d_ff_expert=1536,
               n_shared=2, d_ff_shared=3072,
               first_dense_layers=1, d_ff_dense=12288),
    supports_long=False,
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2",
)

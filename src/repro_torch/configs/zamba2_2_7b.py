"""zamba2-2.7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B].

54 Mamba2 layers (ssm_state=64) with ONE shared transformer block whose
weights are re-invoked every 6 layers (Zamba2's parameter-sharing
scheme; per-invocation LoRA adapters omitted, as in the JAX package).
Sub-quadratic: the shared attention block runs in sliding-window mode
(window 4096) on long contexts.  The same numbers as
``repro.configs.zamba2_2_7b``.
"""
from repro_torch.configs.base import ArchConfig, Family, SSMCfg

CONFIG = ArchConfig(
    arch_id="zamba2-2.7b",
    family=Family.HYBRID,
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, act="gelu",
    ssm=SSMCfg(state_dim=64, head_dim=64, expand=2, conv_dim=4, chunk=128),
    shared_attn_every=6, sliding_window=4096,
    supports_long=True,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)

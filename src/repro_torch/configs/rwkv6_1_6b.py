"""rwkv6-1.6b — Finch, data-dependent decay [arXiv:2404.05892; unverified].

Attention-free: time-mix blocks run the chunked gated linear recurrence
(``kernels/chunk_scan``) with per-channel data-dependent decay and the
RWKV bonus term.  The same numbers as ``repro.configs.rwkv6_1_6b``.
"""
from repro_torch.configs.base import ArchConfig, Family, SSMCfg

CONFIG = ArchConfig(
    arch_id="rwkv6-1.6b",
    family=Family.SSM,
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, act="relu_sq",
    ssm=SSMCfg(state_dim=64, head_dim=64, chunk=128),
    supports_long=True,
    source="arXiv:2404.05892 (Finch; unverified)",
)

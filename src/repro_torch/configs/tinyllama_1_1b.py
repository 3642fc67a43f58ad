"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf].

The same numbers as ``repro.configs.tinyllama_1_1b``.
"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    arch_id="tinyllama-1.1b",
    family=Family.DENSE,
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000, rope_theta=10000.0, act="silu",
    supports_long=False,
    source="arXiv:2401.02385; hf:TinyLlama/TinyLlama-1.1B",
)

"""minitron-8b — pruned nemotron [arXiv:2407.14679; hf].

The same numbers as ``repro.configs.minitron_8b``.
"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    arch_id="minitron-8b",
    family=Family.DENSE,
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000, rope_theta=10000.0, act="silu",
    supports_long=False,
    source="arXiv:2407.14679; hf:nvidia/Minitron-8B-Base",
)

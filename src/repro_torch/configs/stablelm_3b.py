"""stablelm-3b — [hf:stabilityai/stablelm-2-1_6b; unverified].

The same numbers as ``repro.configs.stablelm_3b``.
"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    arch_id="stablelm-3b",
    family=Family.DENSE,
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304, rope_theta=10000.0, act="silu",
    supports_long=False,
    source="hf:stabilityai/stablelm-2-1_6b (unverified)",
)

"""granite-3-2b — GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

The same numbers as ``repro.configs.granite_3_2b``.
"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    arch_id="granite-3-2b",
    family=Family.DENSE,
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155, rope_theta=10000.0, act="silu",
    tie_embeddings=True,
    supports_long=False,
    source="hf:ibm-granite/granite-3.0-2b-base",
)

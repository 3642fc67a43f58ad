"""paligemma-3b — SigLIP + gemma [arXiv:2407.07726; hf].

The SigLIP vision tower is a stub: the caller passes 256 precomputed
patch embeddings (``img_embeds``), which form a bidirectional prefix
(prefix-LM mask) ahead of the text tokens.  Backbone is the
gemma-2b decoder: 18L, d_model 2048, 8 heads / 1 KV head (MQA),
d_ff 16384, gelu, vocab 257216.  The same numbers as ``repro.configs.paligemma_3b``.
"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    arch_id="paligemma-3b",
    family=Family.VLM,
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, act="gelu", d_head=256,
    n_image_tokens=256, tie_embeddings=True,
    supports_long=False,
    source="arXiv:2407.07726; hf:google/paligemma-3b",
)

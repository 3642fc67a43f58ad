"""whisper-medium — enc-dec, conv frontend (stub) [arXiv:2212.04356].

``seq_len`` is the audio-frame count into the encoder; the conv frontend
is a stub (the encoder takes precomputed frame embeddings).  Decoder
text length = seq_len // 8.  Decode caches both self- and
cross-attention.  The same numbers as ``repro.configs.whisper_medium``.
"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    arch_id="whisper-medium",
    family=Family.AUDIO,
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, act="gelu",
    is_encoder_decoder=True, enc_layers=24, dec_ratio=8,
    supports_long=False,
    source="arXiv:2212.04356 (unverified)",
)

"""LM prototype models (port of ``repro.models``): RWKV6, the Zamba2
hybrid (Mamba2 and a shared attention block), the dense, VLM and MoE
transformer (with Multi-head Latent Attention for DeepSeek-V2), and the
Whisper encoder-decoder."""

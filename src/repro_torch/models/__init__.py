"""LM prototype models (port of ``repro.models``): RWKV6, the Zamba2
hybrid (Mamba2 and a shared attention block), and the dense, VLM and MoE
transformer."""

"""LM prototype models (port of ``repro.models``): RWKV6 and the dense/VLM
transformer."""

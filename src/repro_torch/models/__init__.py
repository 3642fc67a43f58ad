"""LM prototype models (port of ``repro.models``): RWKV6 so far."""

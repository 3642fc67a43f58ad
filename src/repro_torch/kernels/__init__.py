"""The CUDA kernels, their plain PyTorch versions and the glue around them.

Kernel sources live in ``src/repro_torch/csrc``; ``_build`` compiles them
on the first launch, never at import.
"""

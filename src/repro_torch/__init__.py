"""SpliDT on PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``repro`` (``core/``, ``flows/``, ``kernels/``), so each
module's counterpart sits at the same relative path.  The port imports
``torch`` and numpy only, never ``jax`` nor anything of ``repro``; numpy
modules it needs are kept as its own copies.  The hot path runs two CUDA
kernels written for Hopper (``csrc/``), built on first use.

Entry points take ``device=None``, which means the card; pass
``device="cpu"`` for the plain PyTorch path.
"""

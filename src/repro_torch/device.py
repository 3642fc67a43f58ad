"""Device resolution shared by the port's entry points.

The port runs on the card unless the caller asks for the CPU: an entry
point's ``device=None`` means ``"cuda"``, and a missing card is an
error, never a silent fall back to the CPU.

The abstract helpers (``models.model_zoo.abstract_cache``, the dry run)
trace shapes on the ``meta`` device, where nothing is allocated: inside
:func:`on_meta` every device request resolves to ``meta``.  Outside it,
``meta`` is refused like any device but ``cuda`` and ``cpu``.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_ON_META = contextvars.ContextVar("repro_torch_on_meta", default=False)


@contextlib.contextmanager
def on_meta():
    """Within: :func:`resolve_device` returns the ``meta`` device, so the
    entry points build their tensors as shapes alone."""
    token = _ON_META.set(True)
    try:
        yield
    finally:
        _ON_META.reset(token)


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent.
    ``meta`` inside :func:`on_meta`, whatever was asked."""
    if _ON_META.get():
        return torch.device("meta")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

"""Device resolution shared by the port's entry points.

The port runs on the card unless the caller asks for the CPU: an entry
point's ``device=None`` means ``"cuda"``, and a missing card is an
error, never a silent fall back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

"""The process group: one process a rank (the port's own; the JAX package
has no counterpart, since one JAX process holds every device).

Every rank runs the same program and calls :func:`init` with its rank,
the world size and one shared file for the rendezvous (a ``file://``
store: no port to pick, so runs side by side never collide).  The
backend follows the device the caller names and nothing else: NCCL on
the card, gloo when the caller asks for the CPU.  A CUDA request without
a card raises, as ``repro_torch.device.resolve_device`` does; no backend
is chosen behind the caller's back.
"""
from __future__ import annotations

import os

import torch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init(rank: int, world: int, init_file: str, *,
         device: str = "cuda") -> str:
    """Join the group as ``rank`` of ``world`` through ``init_file``
    (created by the first rank, on a file system every rank sees; it must
    not exist before the run).  On ``cuda`` each rank takes the card
    ``rank % device_count``.  Returns the backend's name."""
    import torch.distributed as dist

    if device not in BACKENDS:
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the group on gloo")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        BACKENDS[device], init_method="file://" + os.path.abspath(init_file),
        rank=rank, world_size=world)
    return dist.get_backend()


def destroy() -> None:
    """Leave the group (a no-op when none was formed)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


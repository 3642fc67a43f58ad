"""The process group: one process a rank (the port's own; the JAX package
has no counterpart, since one JAX process holds every device), and a
fake group for counting a sharded program (:func:`fake_group`).

Every rank runs the same program and calls :func:`init` with its rank,
the world size and one shared file for the rendezvous (a ``file://``
store: no port to pick, so runs side by side never collide).  The
backend follows the device the caller names and nothing else: NCCL on
the card, gloo when the caller asks for the CPU.  A CUDA request without
a card raises, as ``repro_torch.device.resolve_device`` does; no backend
is chosen behind the caller's back.
"""
from __future__ import annotations

import contextlib
import math
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



@contextlib.contextmanager
def fake_group(shape: tuple[int, ...], axis_names: tuple[str, ...]):
    """A ``"fake"`` process group of ``prod(shape)`` ranks, this process
    rank 0, and the runtime ``DeviceMesh`` of ``shape`` over
    ``axis_names`` on it, for counting a sharded program: its
    collectives are emitted and return tensors of the right shapes, and
    no byte moves (JAX's dry run compiles for 256 or 512 fake devices
    alike).  The mesh's device type is ``cuda``, the mesh being
    modelled: DTensor then emits an all-to-all as NCCL runs it, where a
    ``cpu`` mesh would stand an all-gather in for it (gloo has none).
    Nothing runs on a card; the data placed on the mesh lives on
    ``meta``.

    Yields the mesh and destroys the group on the way out, whatever
    happens.  Refuses to start while another group is initialised (it is
    never reused).  ``torch.testing._internal.distributed.fake_pg``
    (``FakeStore``) is in torch 2.11 and 2.13."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_device_mesh

    if dist.is_initialized():
        raise RuntimeError(
            f"a process group is already initialised (backend "
            f"{dist.get_backend()!r}, world size {dist.get_world_size()}); "
            "destroy it before counting on a fake group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_device_mesh(tuple(shape), tuple(axis_names),
                               device="cuda")
    finally:
        dist.destroy_process_group()

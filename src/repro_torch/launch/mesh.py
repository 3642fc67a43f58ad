"""Meshes (port of ``repro.launch.mesh``): the flow mesh, the abstract
production mesh and runtime meshes over a process group.

JAX runs one process that holds every device; ``torch.distributed`` runs
one process a rank, each running the same code.  So the port keeps two
kinds of mesh apart:

* an **abstract mesh**, :class:`Mesh`: axis names and sizes only, the
  counterpart of ``jax.sharding.AbstractMesh``.  The spec rules, the
  memory budget and the dry run need nothing more, and no process group
  of 256 ranks exists, so :func:`make_production_mesh` returns one;
* a **runtime mesh**: a ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names``, over the running process group
  (``repro_torch.distributed.group.init``).  Data is placed on it as
  DTensors (``distributed.sharding.NamedSharding.placements``).

:class:`FlowMesh` is the streaming engine's mesh: an ordered tuple of
``torch.device``s on one ``"data"`` axis.  The per-flow walk carries no
state across flows, so a shard needs no collective: each device gets its
own replica of the engine tables and walks its rows (``serve.streaming``).

Building a :class:`Mesh` or a :class:`FlowMesh` touches no device state
beyond counting cards; a runtime mesh is collective (every rank of the
group builds it).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class FlowMesh:
    """Devices on the one ``"data"`` axis, in shard order."""
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a flow mesh needs at least one device")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An abstract mesh: axis names and their sizes, no devices."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{self.axis_names} and {self.shape} differ in "
                             "length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``: JAX's production meshes, as
    abstract meshes."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_flow_mesh(n_data: int | None = None, *,
                   device: str = "cuda") -> FlowMesh:
    """A 1-D ``("data",)`` mesh for flow-batch sharding.

    ``device="cuda"``: the first ``n_data`` visible cards (default:
    every one), the serving topology where one host fans flow chunks out
    across its cards; it raises without enough cards.  ``device="cpu"``:
    ``n_data`` (default 1) entries of the CPU, which the tests use as the
    JAX package's tests use fake CPU devices.
    """
    if device == "cpu":
        return FlowMesh(tuple(torch.device("cpu")
                              for _ in range(n_data or 1)))
    if device != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_data is None else n_data
    if n < 1 or n > have:
        raise RuntimeError(f"a flow mesh of {n} cards needs that many; "
                           f"{have} visible")
    return FlowMesh(tuple(torch.device("cuda", i) for i in range(n)))


def make_device_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
                     *, device: str = "cuda"):
    """A runtime mesh of ``shape`` over the first ``prod(shape)`` ranks of
    the running group, in rank order (row-major, as ``jax.make_mesh``
    takes the first devices).  A mesh smaller than the group is a
    sub-mesh: the ranks outside it hold empty local shards of what is
    placed on it.  Collective: every rank of the group calls it.
    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "repro_torch.distributed.group.init first")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"a mesh of {n} ranks needs that many; the group "
                         f"has {world}")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A (data, model) runtime mesh over ("data", "model") (tests and
    small runs)."""
    return make_device_mesh((data, model), ("data", "model"), device=device)


def mesh_shape_dict(mesh) -> dict[str, int]:
    """Axis name -> size of a :class:`Mesh`, a runtime ``DeviceMesh`` or a
    :class:`FlowMesh`, as the JAX package's ``mesh_shape_dict``."""
    if isinstance(mesh, FlowMesh):
        return {"data": len(mesh.devices)}
    if isinstance(mesh, Mesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a :class:`Mesh` or a runtime mesh."""
    if isinstance(mesh, Mesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)

"""The flow mesh: the devices a streamed chunk's flows shard over (port of
the flow half of ``repro.launch.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` with one ``"data"`` axis;
the port's mesh is a small frozen value, an ordered tuple of
``torch.device``s on that one axis.  The per-flow walk carries no state
across flows, so a shard needs no collective: each device gets its own
replica of the engine tables and walks its rows (``serve.streaming``).
Building a mesh touches no device state beyond counting cards.
``make_production_mesh`` belongs to the training half (ROADMAP A.11).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FlowMesh:
    """Devices on the one ``"data"`` axis, in shard order."""
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a flow mesh needs at least one device")


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


def mesh_shape_dict(mesh: FlowMesh) -> dict[str, int]:
    """Axis name -> size, as the JAX package's ``mesh_shape_dict``."""
    return {"data": len(mesh.devices)}

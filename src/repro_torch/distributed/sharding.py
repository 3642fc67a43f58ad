"""Flow-batch sharding over a :class:`~repro_torch.launch.mesh.FlowMesh`
(port of the flow half of ``repro.distributed.sharding``).

The streaming scheduler splits each chunk's flow rows into one
contiguous shard a device, in mesh order; every other axis (partition,
window, packet fields) stays whole on the device.  The parameter and
cache sharding rules belong to the training half (ROADMAP A.11).
"""
from __future__ import annotations

from repro_torch.launch.mesh import FlowMesh, mesh_shape_dict


def flow_batch_devices(mesh: FlowMesh) -> int:
    """How many ways the flow axis splits: the mesh's ``"data"`` size."""
    return mesh_shape_dict(mesh)["data"]


def flow_shards(n_rows: int, n_devices: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` row bounds of each device's shard of ``n_rows`` flows:
    ``ceil(n_rows / n_devices)`` rows a device in order, the last shards
    shorter or empty when the rows do not divide."""
    if n_devices <= 0:
        raise ValueError("n_devices must be positive")
    per = -(-n_rows // n_devices)
    return [(min(j * per, n_rows), min((j + 1) * per, n_rows))
            for j in range(n_devices)]

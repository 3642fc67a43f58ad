"""Published peaks of the cards a cell may run on, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W: 3.35 TB/s of
HBM3, 67 TFLOP/s f32 outside the tensor cores.  A card set below 700 W
runs slower under load; results carry its power limit beside them.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
}


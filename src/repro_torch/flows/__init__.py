"""Synthetic flows and windowed features."""
from repro_torch.flows.synthetic import FlowDataset, make_dataset  # noqa: F401
from repro_torch.flows.windows import (  # noqa: F401
    full_flow_features, window_features,
)

"""CICFlowMeter-style windowed feature extraction (port of
``repro.flows.windows``).

The paper modifies CICFlowMeter to emit feature statistics at every
window boundary and reset flow state afterwards (§5 Dataset Generation).
This module is the offline analogue: it slices each flow into ``p``
uniform windows and computes the full N-feature vector per window.

Window semantics mirror the data plane exactly:
  * windows are uniform: ``len // p`` packets, remainder to the LAST
    window (so every window is non-empty for flows with len >= p);
  * the dependency chain is cleared at each window boundary, so the
    first packet of every window has IAT = 0;
  * padding packets have valid = 0 and contribute to nothing;
  * features are computed by the engine's own register math
    (``kernels.ops.feature_window_rows`` with all 41 slots): the CUDA
    feature kernel on the card, its plain version on the CPU.  So
    training-time thresholds and inference-time registers agree bit for
    bit, which is why kernel A must equal the plain version exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.features import (
    FEATURE_TABLE, N_FEATURES, PKT_IAT, PKT_NFIELDS, REGISTRY,
)
from repro_torch.device import resolve_device
from repro_torch.flows.synthetic import FlowDataset
from repro_torch.kernels.ops import feature_window_rows

_FLOW_BATCH = 2048


def window_bounds(length: int, p: int) -> list[tuple[int, int]]:
    """Uniform window [start, end) bounds; remainder goes to last window."""
    base = max(length // p, 1)
    bounds = []
    for w in range(p):
        lo = min(w * base, length)
        hi = length if w == p - 1 else min((w + 1) * base, length)
        bounds.append((lo, hi))
    return bounds


def _all_feature_rows(n: int, device: torch.device
                      ) -> tuple[torch.Tensor, ...]:
    """Slot rows covering ALL registry features (k = N_FEATURES)."""
    init = np.asarray([s.init_value for s in REGISTRY], np.float32)
    rows = (FEATURE_TABLE[:, 0], FEATURE_TABLE[:, 1], FEATURE_TABLE[:, 2],
            init)
    return tuple(torch.as_tensor(r).to(device).expand(n, -1).contiguous()
                 for r in rows)


def window_features(ds: FlowDataset, p: int, *,
                    device: "str | torch.device | None" = None
                    ) -> np.ndarray:
    """Per-window features: returns ``(n_flows, p, N_FEATURES)`` f32.

    Computed from the exact same padded window tensor the engine
    consumes, so offline (training) features and runtime registers are
    bit-identical.  ``device=None`` means the card (the feature kernel);
    pass ``device="cpu"`` for the plain PyTorch version.
    """
    dev = resolve_device(device)
    wp = torch.from_numpy(window_packets(ds, p)).to(dev)   # (n, p, W, F)
    n = ds.n_flows
    out = torch.zeros((n, p, N_FEATURES), dtype=torch.float32, device=dev)
    for lo in range(0, n, _FLOW_BATCH):
        hi = min(lo + _FLOW_BATCH, n)
        rows = _all_feature_rows(hi - lo, dev)
        for w in range(p):
            out[lo:hi, w] = feature_window_rows(wp[lo:hi, w], *rows)
    return out.cpu().numpy()


def window_packets(ds: FlowDataset, p: int) -> np.ndarray:
    """Window-major packet tensor for the data-plane engine.

    Returns ``(n_flows, p, W_max, PKT_NFIELDS)`` with per-window padding
    (valid=0) and the dependency chain cleared at window starts
    (first-packet IAT = 0), matching :func:`window_features` semantics.
    """
    n = ds.n_flows
    w_max = 1
    for L in np.unique(ds.lengths):
        for lo, hi in window_bounds(int(L), p):
            w_max = max(w_max, hi - lo)
    out = np.zeros((n, p, w_max, PKT_NFIELDS), dtype=np.float32)
    for L in np.unique(ds.lengths):
        rows = np.nonzero(ds.lengths == L)[0]
        pk = ds.packets[rows]
        for w, (lo, hi) in enumerate(window_bounds(int(L), p)):
            if hi <= lo:
                continue
            win = pk[:, lo:hi].copy()
            win[:, 0, PKT_IAT] = 0.0
            out[rows, w, :hi - lo] = win
    return out

"""The work of a batch's walk, counted from the inputs and the
reference's walk, the same whatever implements it.

* bytes: every valid packet (6 f32 fields, 24 bytes) of each window a
  flow's walk visits, read once; the three int32 verdict fields of every
  flow written once; the model's trees read once, 16 bytes a node
  (feature, threshold and the two children, 4 bytes each);
* operations: 2 f32 operations (a select or product, and an
  accumulation) a visited packet and feature its subtree reads, and one
  comparison a tree level the flow descends.

Padding rows, the program's tables and its carry are not counted.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .trainer import Model
from .walk import Walk
from .windows import window_lengths

PACKET_BYTES = 6 * 4
VERDICT_BYTES = 3 * 4
NODE_BYTES = 16


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    ops: float

    def least_s(self, peak_bytes_per_s: float, peak_ops_per_s: float
                ) -> tuple[float, str]:
        """The least time on a device of these peaks, and what bounds it."""
        t_bytes = self.bytes / peak_bytes_per_s
        t_ops = self.ops / peak_ops_per_s
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tree_bytes(model: Model) -> int:
    return NODE_BYTES * sum(s.tree.feature.shape[0] for s in model.subtrees)


def per_flow(model: Model, lengths: np.ndarray, w: Walk
             ) -> tuple[np.ndarray, np.ndarray]:
    """Bytes and operations of each flow's walk, without the trees."""
    visited = w.sid >= 0                                   # (n, P)
    pk = window_lengths(lengths, model.n_partitions) * visited
    n_used = np.asarray([np.unique(s.tree.feature[s.tree.feature >= 0]).size
                         for s in model.subtrees], np.int64)
    feats = np.where(visited, n_used[np.maximum(w.sid, 0)], 0)
    nbytes = PACKET_BYTES * pk.sum(axis=1) + VERDICT_BYTES
    ops = 2 * (pk * feats).sum(axis=1) + w.leaf_depth.sum(axis=1)
    return nbytes, ops


def batch_work(model: Model, lengths: np.ndarray, w: Walk,
               rows: np.ndarray) -> Work:
    """The work of one walk over the pool flows ``rows``."""
    nbytes, ops = per_flow(model, lengths, w)
    times = np.bincount(rows, minlength=lengths.shape[0]).astype(np.float64)
    return Work(float(times @ nbytes) + tree_bytes(model),
                float(times @ ops))

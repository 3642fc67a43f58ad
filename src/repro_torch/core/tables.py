"""Packed device tables for the partitioned-DT inference engine
(a copy of ``repro.core.tables``).

The data plane stores a partitioned DT as dense, SID-indexed tables
(paper Fig. 4): operator-selection tables (which op/field/predicate each
of the k register slots runs for the active subtree), and the model
tables (node compare-and-descend programs + per-leaf routing).  This
module packs a trained :class:`PartitionedDT` into flat numpy arrays the
engine and the CUDA kernels consume.

Encoding (S = #subtrees, M = max nodes over subtrees, k = slots):
  node_feat_slot (S, M) int32: local slot [0..k) for internal, -1 leaf
  node_thresh    (S, M) f32
  node_left/right(S, M) int32
  leaf_next_sid  (S, M) int32: next SID, or -1 for exit
  leaf_label     (S, M) int32
  slot_fid       (S, k) int32: global feature id per slot (-1 unused)
  slot_op        (S, k) int32   | per-slot op codes (operator-selection
  slot_field     (S, k) int32   | MAT contents, keyed by SID)
  slot_pred      (S, k) int32   |
  slot_init      (S, k) f32: register init value (0, or +inf for MIN)
  sid_partition  (S,) int32
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.features import REGISTRY
from repro_torch.core.partition import EXIT, PartitionedDT


@dataclasses.dataclass
class PackedTables:
    node_feat_slot: np.ndarray
    node_thresh: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    leaf_next_sid: np.ndarray
    leaf_label: np.ndarray
    slot_fid: np.ndarray
    slot_op: np.ndarray
    slot_field: np.ndarray
    slot_pred: np.ndarray
    slot_init: np.ndarray
    sid_partition: np.ndarray
    n_partitions: int
    k: int
    max_depth: int      # max subtree depth (traversal iteration bound)

    @property
    def n_subtrees(self) -> int:
        return int(self.node_feat_slot.shape[0])

    @property
    def max_nodes(self) -> int:
        return int(self.node_feat_slot.shape[1])


def pack_tables(pdt: PartitionedDT) -> PackedTables:
    S = len(pdt.subtrees)
    M = max(max(st.tree.n_nodes for st in pdt.subtrees), 2)
    k = pdt.k

    node_feat_slot = np.full((S, M), -1, dtype=np.int32)
    node_thresh = np.zeros((S, M), dtype=np.float32)
    node_left = np.zeros((S, M), dtype=np.int32)
    node_right = np.zeros((S, M), dtype=np.int32)
    leaf_next_sid = np.full((S, M), EXIT, dtype=np.int32)
    # -1 sentinel on non-leaf rows (docs/PARITY.md §2); only leaf rows
    # are ever written with a real class below
    leaf_label = np.full((S, M), -1, dtype=np.int32)
    slot_fid = np.full((S, k), -1, dtype=np.int32)
    slot_op = np.zeros((S, k), dtype=np.int32)
    slot_field = np.zeros((S, k), dtype=np.int32)
    slot_pred = np.zeros((S, k), dtype=np.int32)
    slot_init = np.zeros((S, k), dtype=np.float32)
    sid_partition = np.zeros(S, dtype=np.int32)

    for st in pdt.subtrees:
        s = st.sid
        t = st.tree
        sid_partition[s] = st.partition
        used = list(map(int, st.used_features))
        if len(used) > k:
            raise ValueError(f"subtree {s} uses {len(used)} > k={k} features")
        fid_to_slot = {fid: j for j, fid in enumerate(used)}
        for j, fid in enumerate(used):
            spec = REGISTRY[fid]
            slot_fid[s, j] = fid
            slot_op[s, j] = spec.op
            slot_field[s, j] = spec.field
            slot_pred[s, j] = spec.pred
            slot_init[s, j] = spec.init_value
        for i in range(t.n_nodes):
            f = int(t.feature[i])
            if f >= 0:
                node_feat_slot[s, i] = fid_to_slot[f]
                node_thresh[s, i] = t.threshold[i]
                node_left[s, i] = t.left[i]
                node_right[s, i] = t.right[i]
            else:
                leaf_next_sid[s, i] = st.leaf_next_sid.get(i, EXIT)
                leaf_label[s, i] = st.leaf_label.get(i, -1)

    return PackedTables(
        node_feat_slot=node_feat_slot, node_thresh=node_thresh,
        node_left=node_left, node_right=node_right,
        leaf_next_sid=leaf_next_sid, leaf_label=leaf_label,
        slot_fid=slot_fid, slot_op=slot_op, slot_field=slot_field,
        slot_pred=slot_pred, slot_init=slot_init,
        sid_partition=sid_partition,
        n_partitions=pdt.n_partitions, k=k,
        max_depth=max(st.tree.max_depth for st in pdt.subtrees),
    )

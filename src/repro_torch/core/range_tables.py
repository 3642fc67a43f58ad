"""Range-execution tables: the dense form of the MAT pipeline
(a copy of ``repro.core.range_tables``).

A Tofino MAT matches (SID, range marks) against TCAM rules.  The
engine replaces pointer-chasing tree traversal with the *same*
range-marking semantics as dense compute:

  mark_j   = #{ t in thresholds[sid, j] : value_j > t }        (compare+count)
  hit(l)   = AND_j  lo[sid, l, j] <= mark_j <= hi[sid, l, j]    (dense match)
  action   = first hit's action                                (priority encode)

Tables are padded to rectangular arrays so the CUDA range-match kernel
can stage one subtree's tables in shared memory per thread block (flows
grouped by SID, MoE-dispatch style).

Action encoding: ``action < n_subtrees`` -> transition to that SID;
``action >= n_subtrees`` -> exit with class ``action - n_subtrees``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.partition import EXIT, PartitionedDT

_PAD = 8  # pad threshold/leaf axes to multiples of this


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class RangeExecTables:
    """Dense per-SID matching tables.

    thresholds (S, k, T) f32, padded with +inf
    leaf_lo    (S, L, k) int32   inclusive mark interval per slot
    leaf_hi    (S, L, k) int32   (wildcard slots: [0, T])
    leaf_action(S, L)    int32   next-SID or n_subtrees+class; -1 padding
    leaf_valid (S, L)    bool
    """
    thresholds: np.ndarray
    leaf_lo: np.ndarray
    leaf_hi: np.ndarray
    leaf_action: np.ndarray
    leaf_valid: np.ndarray
    n_subtrees: int
    n_classes: int

    @property
    def k(self) -> int:
        return int(self.thresholds.shape[1])

    @property
    def max_thresholds(self) -> int:
        return int(self.thresholds.shape[2])

    @property
    def max_leaves(self) -> int:
        return int(self.leaf_lo.shape[1])

    def decode_action(self, action: np.ndarray):
        """-> (is_exit, next_sid, label)"""
        is_exit = action >= self.n_subtrees
        next_sid = np.where(is_exit, 0, action)
        # non-exit rows carry the -1 sentinel (docs/PARITY.md §2), never
        # a fake class 0
        label = np.where(is_exit, action - self.n_subtrees, -1)
        return is_exit, next_sid, label


def pack_range_exec(pdt: PartitionedDT) -> RangeExecTables:
    S, k = len(pdt.subtrees), pdt.k
    thr_lists: list[list[np.ndarray]] = []
    max_t = 1
    # per-subtree, per-slot sorted thresholds
    for st in pdt.subtrees:
        per_f = st.tree.thresholds_per_feature()
        used = list(map(int, st.used_features))
        slots = []
        for j in range(k):
            if j < len(used):
                t = per_f.get(used[j], np.zeros(0))
            else:
                t = np.zeros(0)
            slots.append(np.sort(np.asarray(t, dtype=np.float32)))
            max_t = max(max_t, len(slots[-1]))
        thr_lists.append(slots)
    T = _round_up(max_t, _PAD)

    max_l = max(max(st.tree.n_leaves for st in pdt.subtrees), 1)
    L = _round_up(max_l, _PAD)

    thresholds = np.full((S, k, T), np.inf, dtype=np.float32)
    leaf_lo = np.zeros((S, L, k), dtype=np.int32)
    leaf_hi = np.full((S, L, k), T, dtype=np.int32)
    leaf_action = np.full((S, L), -1, dtype=np.int32)
    leaf_valid = np.zeros((S, L), dtype=bool)

    for st in pdt.subtrees:
        s = st.sid
        used = list(map(int, st.used_features))
        fid_to_slot = {fid: j for j, fid in enumerate(used)}
        for j, tlist in enumerate(thr_lists[s]):
            thresholds[s, j, :len(tlist)] = tlist
        # walk root->leaf accumulating slot-local mark intervals
        t = st.tree
        li = 0

        def walk(node: int, lo: np.ndarray, hi: np.ndarray):
            nonlocal li
            f = int(t.feature[node])
            if f < 0:
                leaf_lo[s, li] = lo
                leaf_hi[s, li] = hi
                nxt = st.leaf_next_sid.get(node, EXIT)
                if nxt == EXIT:
                    leaf_action[s, li] = S + st.leaf_label[node]
                else:
                    leaf_action[s, li] = nxt
                leaf_valid[s, li] = True
                li += 1
                return
            j = fid_to_slot[f]
            thr = float(t.threshold[node])
            tl = thr_lists[s][j]
            split_mark = int(np.searchsorted(tl, thr, side="left"))
            llo, lhi = lo.copy(), hi.copy()
            lhi[j] = min(lhi[j], split_mark)
            walk(int(t.left[node]), llo, lhi)
            rlo, rhi = lo.copy(), hi.copy()
            rlo[j] = max(rlo[j], split_mark + 1)
            walk(int(t.right[node]), rlo, rhi)

        walk(0, np.zeros(k, dtype=np.int32), np.full(k, T, dtype=np.int32))

    return RangeExecTables(
        thresholds=thresholds, leaf_lo=leaf_lo, leaf_hi=leaf_hi,
        leaf_action=leaf_action, leaf_valid=leaf_valid,
        n_subtrees=S, n_classes=pdt.n_classes,
    )

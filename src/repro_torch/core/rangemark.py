"""Range-Marking rule generation (NetBeacon's algorithm, paper §3.2.1;
a copy of ``repro.core.rangemark``).

Maps a (sub)tree's feature thresholds to per-feature *range marks* and
the tree's leaves to model-table entries:

  * Feature tables: for each feature used by the subtree, its sorted
    thresholds t_1 < ... < t_r segment the domain into r+1 ranges; each
    range gets a mark (its ordinal index).  In TCAM, a range over a
    W-bit field is matched with its minimal prefix cover; we count exact
    prefix-cover entries (classic <= 2W-2 bound per range).
  * Model table: each leaf constrains every feature to a *contiguous*
    interval of marks, so one leaf = one entry (paper: "one TCAM rule
    per leaf"), matched together with an exact SID key.

Both executable rule tables and TCAM entry/bit counts are produced; a
property test asserts rule-table semantics == direct tree traversal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.tree import Tree


def prefix_cover_count(lo: int, hi: int, width: int) -> int:
    """Number of ternary prefixes needed to match the integer range
    [lo, hi] within a ``width``-bit field (minimal prefix cover)."""
    if hi < lo:
        return 0
    lo = max(int(lo), 0)
    hi = min(int(hi), (1 << width) - 1)
    count = 0
    while lo <= hi:
        # largest aligned power-of-two block starting at lo that fits
        b = lo & -lo if lo > 0 else 1 << width
        while lo + b - 1 > hi:
            b >>= 1
        count += 1
        lo += b
    return count


def quantize_thresholds(thresholds: np.ndarray, lo: float, hi: float,
                        bits: int) -> np.ndarray:
    """Map float thresholds into the ``bits``-wide register domain."""
    span = max(hi - lo, 1e-9)
    levels = (1 << bits) - 1
    q = np.floor((np.asarray(thresholds, dtype=np.float64) - lo) / span * levels)
    return np.clip(q, 0, levels).astype(np.int64)


@dataclasses.dataclass
class FeatureRangeTable:
    """Executable range->mark table for one feature of one subtree."""
    fid: int
    thresholds: np.ndarray          # sorted float thresholds (r,)
    mark_bits: int
    tcam_entries: int               # prefix-cover entry count
    # executable form: mark(value) = searchsorted(thresholds, value, 'left')
    #   value <= t_1 -> 0 ; t_1 < value <= t_2 -> 1 ; ... ; value > t_r -> r

    def marks(self, values: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.thresholds, values, side="left").astype(np.int64)


@dataclasses.dataclass
class LeafRule:
    leaf: int
    # per-fid inclusive mark interval; features absent from the path are
    # wildcarded (don't-care) in TCAM
    mark_intervals: dict[int, tuple[int, int]]
    action: int                     # next SID or class (interpreted by caller)


@dataclasses.dataclass
class SubtreeRules:
    feature_tables: dict[int, FeatureRangeTable]
    leaf_rules: list[LeafRule]
    model_entries: int              # == len(leaf_rules) (one rule per leaf)
    feature_entries: int            # sum of prefix-cover counts
    key_bits: int                   # model-table match key width (sid+marks)

    @property
    def total_entries(self) -> int:
        return self.model_entries + self.feature_entries

    def tcam_bits(self, sid_bits: int = 8) -> int:
        feat_bits = 0
        for ft in self.feature_tables.values():
            # feature-table entry: value (register width proxy: use the
            # threshold quantisation width) -> handled by caller via
            # entry counts x field width; here count mark/key bits only.
            feat_bits += ft.tcam_entries * 32
        return feat_bits + self.model_entries * self.key_bits

    def apply(self, X: np.ndarray) -> np.ndarray:
        """Execute the rule tables on raw features (n, N) -> action (n,).

        First matching leaf rule wins (TCAM priority order).
        """
        n = X.shape[0]
        marks = {fid: ft.marks(X[:, fid]) for fid, ft in self.feature_tables.items()}
        out = np.full(n, -1, dtype=np.int64)
        unmatched = np.ones(n, dtype=bool)
        for rule in self.leaf_rules:
            hit = unmatched.copy()
            for fid, (lo, hi) in rule.mark_intervals.items():
                m = marks[fid]
                hit &= (m >= lo) & (m <= hi)
            out[hit] = rule.action
            unmatched &= ~hit
        return out


def build_subtree_rules(
    tree: Tree,
    leaf_action: dict[int, int],
    *,
    bits: int = 32,
    feature_ranges: dict[int, tuple[float, float]] | None = None,
    sid_bits: int = 8,
) -> SubtreeRules:
    """Generate range-marking rules for one subtree.

    ``leaf_action``: leaf node id -> action (next SID or class label,
    encoded by the caller).  ``feature_ranges``: observed (lo, hi) per
    feature for threshold quantisation when counting TCAM entries.
    """
    thr_per_f = tree.thresholds_per_feature()
    feature_tables: dict[int, FeatureRangeTable] = {}
    feature_entries = 0
    key_bits = sid_bits
    for fid, thr in sorted(thr_per_f.items()):
        r = len(thr)
        mark_bits = max(int(np.ceil(np.log2(r + 1))), 1)
        if feature_ranges and fid in feature_ranges:
            lo, hi = feature_ranges[fid]
        else:
            lo, hi = float(thr.min()), float(thr.max() + 1.0)
        qt = quantize_thresholds(thr, lo, hi, bits)
        # ranges in the integer domain: [0, q1], [q1+1, q2], ..., [qr+1, max]
        edges = np.concatenate([[-1], qt, [(1 << bits) - 1]])
        entries = 0
        for i in range(len(edges) - 1):
            entries += prefix_cover_count(int(edges[i]) + 1, int(edges[i + 1]), bits)
        ft = FeatureRangeTable(fid=fid, thresholds=thr.astype(np.float64),
                               mark_bits=mark_bits, tcam_entries=entries)
        feature_tables[fid] = ft
        feature_entries += entries
        key_bits += mark_bits

    # walk root->leaf paths accumulating per-feature mark intervals
    leaf_rules: list[LeafRule] = []

    def walk(node: int, intervals: dict[int, tuple[int, int]]):
        f = int(tree.feature[node])
        if f < 0:
            leaf_rules.append(LeafRule(
                leaf=node, mark_intervals=dict(intervals),
                action=int(leaf_action.get(node, -1))))
            return
        thr = float(tree.threshold[node])
        ft = feature_tables[f]
        # mark of the range containing values <= thr is searchsorted('left')
        split_mark = int(np.searchsorted(ft.thresholds, thr, side="left"))
        lo, hi = intervals.get(f, (0, len(ft.thresholds)))
        # left: value <= thr -> mark <= split_mark
        li = dict(intervals)
        li[f] = (lo, min(hi, split_mark))
        walk(int(tree.left[node]), li)
        # right: value > thr -> mark >= split_mark + 1
        ri = dict(intervals)
        ri[f] = (max(lo, split_mark + 1), hi)
        walk(int(tree.right[node]), ri)

    walk(0, {})
    return SubtreeRules(
        feature_tables=feature_tables,
        leaf_rules=leaf_rules,
        model_entries=len(leaf_rules),
        feature_entries=feature_entries,
        key_bits=key_bits,
    )

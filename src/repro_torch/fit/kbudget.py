"""SpliDT's k-distinct-feature register budget (port of
``repro.fit.kbudget``), over a whole subtree fleet.

Every SpliDT subtree must fit its features into the ``k`` register
slots the data plane time-shares across partitions (paper §2.2), so the
trainer caps the number of *distinct* features per tree.  The numpy
oracle enforces this greedily in level order: each node sees the set of
features used by every node decided before it (above it, or to its
left on the same level); once that set reaches ``k``, only those
features remain candidates.

Greedy acquisition is sequential -- slot ``i``'s candidate mask depends
on slot ``i-1``'s choice -- so :func:`budget_level` replays it as a loop
over the level's frontier slots, vectorised over the fleet's S trees.
It runs on the host in numpy: the grower (``repro_torch.fit.hist``)
fetches the level's per-(node, feature) best splits once, so a level
costs one host sync, where a device loop would launch about ten small
kernels for each of up to 512 slots.  Slots where no tree of the fleet
holds ``2 * min_samples_leaf`` samples decline to split in every tree
and never advance the used mask, so the loop skips them.

This is also where every other per-node split gate lives (purity,
``min_samples_leaf``, ``min_gain``): the accept decision is the single
point that must mirror ``core.tree.train_tree``'s leaf checks -- see the
contract list in ``core/tree.py``.
"""
from __future__ import annotations

import numpy as np
import torch


def budget_level(
    used_mask: np.ndarray,      # (S, m) bool  features used so far, per tree
    gain: np.ndarray,           # (S, F, m) f32 best gain per (node, feature)
    bins: np.ndarray,           # (S, F, m) i32 best split bin per (node, feature)
    nl: np.ndarray,             # (S, F, m) i32 left-child size at that bin
    total: np.ndarray,          # (S, F, C) i32 per-node class counts
    *,
    allowed_mask: np.ndarray,   # (m,) bool, shared by the fleet
    k_features: int,
    min_samples_leaf: int,
    min_gain32: np.float32,
):
    """Greedy per-node feature selection for one frontier level of S trees.

    Walks the level's slots in heap order (== the numpy trainer's BFS
    queue order).  For each node: restrict candidates to the budget
    (``allowed`` while the tree's distinct-feature count is below
    ``k_features``, else ``allowed & used``), take the first-argmax
    feature over masked gains (lowest feature index wins ties), then
    apply the oracle's leaf gates -- purity, ``2*min_samples_leaf``
    node size, strict ``min_gain`` improvement, per-child
    ``min_samples_leaf``.  Accepted splits update the used mask that
    the NEXT slot of the same tree sees.

    Returns ``(used_mask (S, m), feat (S, F) i32 [-1 = leaf],
    bin (S, F) i32)``; ``used_mask`` is a new array.
    """
    S, F, _ = gain.shape
    used = np.array(used_mask, dtype=bool, copy=True)
    allowed = np.asarray(allowed_mask, dtype=bool)[None, :]
    msl = int(min_samples_leaf)
    g32 = np.float32(min_gain32)
    feat = np.full((S, F), -1, dtype=np.int32)
    bin_out = np.zeros((S, F), dtype=np.int32)
    n_node = total.sum(axis=2, dtype=np.int64)                 # (S, F)
    pure = (total > 0).sum(axis=2) <= 1
    trees = np.arange(S)
    for i in np.nonzero((n_node >= 2 * msl).any(axis=0))[0]:
        budget_open = used.sum(axis=1) < k_features            # (S,)
        cand = np.where(budget_open[:, None], allowed, allowed & used)
        g = np.where(cand, gain[:, i], np.float32(-np.inf))
        j = g.argmax(axis=1)                        # first max: lowest fid
        gj = g[trees, j]
        nlj = nl[:, i][trees, j].astype(np.int64)
        nrj = n_node[:, i] - nlj
        ok = ((~pure[:, i]) & (n_node[:, i] >= 2 * msl) & (gj > g32)
              & (nlj >= msl) & (nrj >= msl))
        feat[:, i] = np.where(ok, j, -1)
        bin_out[:, i] = np.where(ok, bins[:, i][trees, j], 0)
        used[trees[ok], j[ok]] = True
    return used, feat, bin_out


def distinct_feature_count(feature, n_features: int) -> torch.Tensor:
    """Number of distinct features a flat ``feature`` array uses (>= 0
    entries) -- the quantity the budget caps; handy for property tests."""
    f = torch.as_tensor(feature)
    onehot = ((f[:, None] == torch.arange(n_features, dtype=f.dtype,
                                          device=f.device)[None, :])
              & (f[:, None] >= 0))
    return onehot.any(dim=0).sum()

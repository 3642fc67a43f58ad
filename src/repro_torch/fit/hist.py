"""Level-synchronous histogram tree induction on the device (port of
``repro.fit.hist``).

The XGBoost/LightGBM formulation of CART in PyTorch tensor ops: features
are quantile-binned on the host (``core.tree.quantile_bins`` -- the
shared cross-trainer contract), then a whole subtree fleet grows one
level at a time on a fixed ``2**(d+1)-1`` heap arena per tree (node
``a``'s children are ``2a+1`` / ``2a+2``), the level loop in Python:

* every sample carries its current arena position; one scatter-add
  builds the level's int32 ``(tree * node, feature, bin, class)``
  histogram, inactive samples routed to one spare slot that is cut off;
* per-(node, feature) best splits fall out of an int32 cumulative sum
  over bins -- the same f32 ``split_scores`` math as the numpy oracle,
  each f32 operation its own eager op (no fused multiply-add can form)
  and the class chain pinned left to right (:func:`class_sq_chain`);
* the level's best splits come to the host in one fetch, where the
  k-distinct-feature register budget runs (``repro_torch.fit.kbudget``),
  and the chosen splits go back up;
* samples descend (``bin <= split_bin`` == ``x <= edges[split_bin]``,
  exactly) and the next level repeats.  Level ``l`` scores only its own
  ``2**l`` slots; once no tree of the fleet splits, the levels below
  hold leaves only and are not run, and the bottom level's class counts
  come from the last level's cumulative counts, with no descent.

The result is **structurally identical** to
:func:`repro_torch.core.tree.train_tree` -- same feature/threshold/
left/right/value arrays, node for node (tie-break: lowest bin, then
lowest feature; see the contract in ``core/tree.py`` and
docs/PARITY.md).  ``repro_torch.fit.batched`` stacks whole subtree
fleets for :func:`grow_forest_arenas`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import MAX_BINS, Tree, bin_data, quantile_bins
from repro_torch.fit import kbudget

#: device-to-host fetches of the grower since the last reset, one a level
#: run; each is one host sync on the card (``chip_smoke.py`` reads it per
#: partition)
host_syncs = 0


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """The tensors as host arrays, behind one host sync: on the card each
    is copied asynchronously into pinned memory and the stream is
    synchronised once."""
    global host_syncs
    host_syncs += 1
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in out]


def class_sq_chain(counts: torch.Tensor) -> torch.Tensor:
    """``sum_c counts[...,c]^2`` as a left-to-right f32 chain.

    The twin of :func:`repro_torch.core.tree.class_sq_chain`: the only
    order-sensitive reduction in the split score, pinned as separate
    multiply and add ops so nothing can re-associate or contract it away
    from the numpy oracle's bits.
    """
    acc = torch.zeros(counts.shape[:-1], dtype=torch.float32,
                      device=counts.device)
    for c in range(counts.shape[-1]):
        x = counts[..., c].to(torch.float32)
        acc = acc + x * x
    return acc


def _level_hist(binned, y, seg, *, frontier, nbins, n_classes):
    """(tree, node, feature, bin, class) counts for one level of a fleet.

    ``binned`` (S, n, m) int32, ``y`` (S, n) int32, ``seg`` (S, n) int32
    -- frontier-local node index, or ``frontier`` for inactive samples,
    whose counts land in one spare slot past the end that is cut off (an
    index out of range would raise on the CPU and assert on the card).
    Returns (S, frontier, m, nbins, n_classes) int32.
    """
    S, n, m = binned.shape
    size = S * frontier * m * nbins * n_classes
    dev = binned.device
    tree = torch.arange(S, dtype=torch.int64, device=dev)[:, None]
    node = tree * frontier + seg.to(torch.int64)                 # (S, n)
    j = torch.arange(m, dtype=torch.int64, device=dev)
    idx = ((node[..., None] * m + j) * nbins + binned.to(torch.int64)) \
        * n_classes + y.to(torch.int64)[..., None]               # (S, n, m)
    idx = torch.where((seg < frontier)[..., None], idx, size)
    flat = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    flat.index_add_(0, idx.reshape(-1),
                    torch.ones(1, dtype=torch.int32, device=dev)
                    .expand(idx.numel()))
    return flat[:size].view(S, frontier, m, nbins, n_classes)


def _level_scores(hist: torch.Tensor):
    """Best split per (node, feature) from the level histogram.

    The twin of :func:`repro_torch.core.tree.split_scores` +
    :func:`repro_torch.core.tree.node_impurity`, vectorised over the node
    and feature axes.  ``hist`` (N, m, nbins, C) int32 (N = trees x
    slots).  Returns ``(gain (N, m) f32, bin (N, m) i32, nl (N, m) i32,
    total (N, C) i32, left (N, m, C) i32)`` where ``bin`` is the first
    (lowest) argmin of the child impurity, ``gain`` is ``-inf`` where no
    valid split exists and ``left`` is the class counts at bins ``<= bin``
    (the split's left side).
    Integer sums stay int32; each f32 operation is its own op, in the
    oracle's order.
    """
    i32, f32 = torch.int32, torch.float32
    cum = torch.cumsum(hist, dim=2, dtype=i32)                 # (N, m, nbins, C)
    total = cum[:, 0, -1, :]                                   # (N, C)
    nl = cum.sum(dim=3, dtype=i32)                             # (N, m, nbins)
    n_node = total.sum(dim=1, dtype=i32)                       # (N,)
    nr = n_node[:, None, None] - nl
    sl = class_sq_chain(cum)
    sr = class_sq_chain(total[:, None, None, :] - cum)
    nl_f = nl.to(f32)
    nr_f = nr.to(f32)
    left = nl_f - sl / torch.clamp_min(nl_f, 1.0)
    right = nr_f - sr / torch.clamp_min(nr_f, 1.0)
    child = (left + right).masked_fill(~((nl > 0) & (nr > 0)),
                                       float("inf"))
    e = torch.argmin(child, dim=2)                             # first min
    child_best = torch.gather(child, 2, e[..., None])[..., 0]
    n_f = n_node.to(f32)
    parent = n_f - class_sq_chain(total) / torch.clamp_min(n_f, 1.0)
    gain = parent[:, None] - child_best                        # -inf: no split
    nl_best = torch.gather(nl, 2, e[..., None])[..., 0]
    left_best = torch.gather(
        cum, 2, e[:, :, None, None].expand(-1, -1, 1, cum.shape[3]))[:, :, 0]
    return gain, e.to(i32), nl_best, total, left_best


def grow_forest_arenas(binned, y, valid, allowed_mask, *, depth, n_classes,
                       nbins, k_features, min_samples_leaf, min_gain):
    """Grow a stacked subtree fleet level-synchronously on its heap arenas.

    ``binned`` (S, n, m) int32, ``y`` (S, n) int32 and ``valid`` (S, n)
    bool (False rows are padding) are tensors on one device;
    ``allowed_mask`` (m,) bool, a host array, is shared.  One level: the
    histogram and its scores on the device, one fetch (one host sync on
    the card), the budget on the host, the chosen splits uploaded, the
    samples descended.  The bottom level's class counts come with the
    last level's fetch: each split's left side is the cumulative count at
    its bin, so the last level needs no descent.

    Returns host arrays ``(feat (S, depth, F), bin (S, depth, F),
    counts (S, depth, F, C), last_counts (S, 2**depth, C),
    used_mask (S, m))`` with ``F = 2**(depth-1)`` -- level ``l``'s slot
    ``i`` is arena node ``2**l - 1 + i`` (slots beyond ``2**l`` are inert
    padding).  ``feat == -1`` marks leaves; ``last_counts`` covers the
    bottom (never-split) level.  Host code assembles a :class:`Tree` via
    :func:`arena_to_tree`.
    """
    S, n, m = binned.shape
    if depth < 1:
        raise ValueError("grow_forest_arenas needs depth >= 1 (depth-0 "
                         "trees are a single leaf; handle on the host)")
    F = 1 << (depth - 1)
    C = int(n_classes)
    dev = binned.device
    binned = binned.to(torch.int32)
    y = y.to(torch.int32)
    allowed = np.asarray(allowed_mask, dtype=bool)
    feats = np.full((S, depth, F), -1, dtype=np.int32)
    bins_out = np.zeros((S, depth, F), dtype=np.int32)
    counts = np.zeros((S, depth, F, C), dtype=np.int32)
    last_counts = np.zeros((S, 1 << depth, C), dtype=np.int32)
    used = np.zeros((S, m), dtype=bool)

    pos = torch.zeros((S, n), dtype=torch.int32, device=dev)
    at_leaf = torch.zeros((S, n), dtype=torch.bool, device=dev)
    for lvl in range(depth):
        Fl = 1 << lvl
        bottom = lvl == depth - 1
        local = pos - (Fl - 1)
        active = (~at_leaf) & valid
        seg = torch.where(active, local, Fl)
        hist = _level_hist(binned, y, seg, frontier=Fl, nbins=nbins,
                           n_classes=C).view(S * Fl, m, nbins, C)
        scores = _level_scores(hist)
        # the bottom level's class counts are the two sides of each split:
        # left, the counts left of its bin; right, the rest
        gain, e, nl, total, *left = _to_host(*scores[:5 if bottom else 4])
        total = total.reshape(S, Fl, C)
        used, feat, bin_l = kbudget.budget_level(
            used, gain.reshape(S, Fl, m), e.reshape(S, Fl, m),
            nl.reshape(S, Fl, m), total, allowed_mask=allowed,
            k_features=k_features, min_samples_leaf=min_samples_leaf,
            min_gain32=np.float32(min_gain))
        feats[:, lvl, :Fl] = feat
        bins_out[:, lvl, :Fl] = bin_l
        counts[:, lvl, :Fl] = total
        if bottom:
            s_i, slot_i = np.nonzero(feat >= 0)
            lc = left[0].reshape(S, Fl, m, C)[s_i, slot_i, feat[s_i, slot_i]]
            last_counts[s_i, 2 * slot_i] = lc
            last_counts[s_i, 2 * slot_i + 1] = total[s_i, slot_i] - lc
            break
        if not (feat >= 0).any():
            # every active sample is now at a leaf: the levels below and
            # the bottom level hold nothing
            break
        # descend: split samples move to a child, leaf samples freeze
        feat_d = torch.from_numpy(feat).to(dev)
        bin_d = torch.from_numpy(bin_l).to(dev)
        slot = local.clamp(0, Fl - 1).to(torch.int64)
        f = torch.gather(feat_d, 1, slot)
        is_split = active & (f >= 0)
        bsel = torch.gather(binned, 2,
                            f.clamp_min(0).to(torch.int64)[..., None])[..., 0]
        go_left = bsel <= torch.gather(bin_d, 1, slot)   # == x <= edges[bin]
        child = 2 * pos + 1 + (~go_left).to(torch.int32)
        pos = torch.where(is_split, child, pos)
        at_leaf = at_leaf | (active & (f < 0))
    return feats, bins_out, counts, last_counts, used


def grow_arena(binned, y, valid, allowed_mask, *, depth, n_classes, nbins,
               k_features, min_samples_leaf, min_gain):
    """One tree: :func:`grow_forest_arenas` on a fleet of one, ``binned``
    (n, m), ``y`` and ``valid`` (n,); the outputs without the fleet
    axis."""
    out = grow_forest_arenas(
        binned[None], y[None], valid[None], allowed_mask, depth=depth,
        n_classes=n_classes, nbins=nbins, k_features=k_features,
        min_samples_leaf=min_samples_leaf, min_gain=min_gain)
    return tuple(a[0] for a in out)


def arena_to_tree(feats: np.ndarray, bins: np.ndarray, counts: np.ndarray,
                  last_counts: np.ndarray, edges: list[np.ndarray],
                  n_classes: int) -> Tree:
    """Assemble the compact :class:`Tree` from arena outputs (host side).

    Reachable arena nodes are renumbered in ascending heap order, which
    is exactly the numpy trainer's BFS level-order numbering (left
    child before right), so the resulting arrays are comparable
    element-for-element.
    """
    D, F = feats.shape
    A = (1 << (D + 1)) - 1
    feat_h = np.full(A, -1, dtype=np.int64)
    bin_h = np.zeros(A, dtype=np.int64)
    val_h = np.zeros((A, n_classes), dtype=np.float32)
    for lvl in range(D):
        base = (1 << lvl) - 1
        cnt = 1 << lvl
        feat_h[base:base + cnt] = feats[lvl, :cnt]
        bin_h[base:base + cnt] = bins[lvl, :cnt]
        val_h[base:base + cnt] = counts[lvl, :cnt]
    val_h[(1 << D) - 1:] = last_counts

    exists = np.zeros(A, dtype=bool)
    exists[0] = True
    order: list[int] = []
    for a in range(A):                      # ascending == level order
        if not exists[a]:
            continue
        order.append(a)
        if feat_h[a] >= 0:
            exists[2 * a + 1] = True
            exists[2 * a + 2] = True
    new_id = {a: i for i, a in enumerate(order)}

    n_nodes = len(order)
    feature = np.full(n_nodes, -1, dtype=np.int32)
    threshold = np.zeros(n_nodes, dtype=np.float32)
    left = np.full(n_nodes, -1, dtype=np.int32)
    right = np.full(n_nodes, -1, dtype=np.int32)
    value = np.zeros((n_nodes, n_classes), dtype=np.float32)
    for a in order:
        i = new_id[a]
        value[i] = val_h[a]
        f = int(feat_h[a])
        if f >= 0:
            feature[i] = f
            threshold[i] = np.float32(edges[f][int(bin_h[a])])
            left[i] = new_id[2 * a + 1]
            right[i] = new_id[2 * a + 2]
    return Tree(feature=feature, threshold=threshold, left=left, right=right,
                value=value, n_classes=n_classes)


def leaf_tree(y: np.ndarray, n_classes: int) -> Tree:
    """Depth-0 degenerate tree: a single leaf holding the class counts."""
    counts = np.bincount(np.asarray(y, dtype=np.int64),
                         minlength=n_classes).astype(np.float32)
    return Tree(feature=np.asarray([-1], np.int32),
                threshold=np.zeros(1, np.float32),
                left=np.asarray([-1], np.int32),
                right=np.asarray([-1], np.int32),
                value=counts[None, :], n_classes=n_classes)


def bin_for_growth(X: np.ndarray, max_bins: int = MAX_BINS):
    """Host-side contract binning for one subtree's subset.

    Returns ``(edges, binned int32)`` via the shared
    :func:`repro_torch.core.tree.quantile_bins` / :func:`bin_data` -- the
    numpy trainer computes the identical edges from the identical
    subset, which is what makes thresholds bit-equal across trainers.
    """
    X = np.asarray(X, dtype=np.float32)
    edges = quantile_bins(X, max_bins)
    binned = bin_data(X, edges).astype(np.int32)
    return edges, binned

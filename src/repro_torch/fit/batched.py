"""Batched training and batched DSE scoring on the device (port of
``repro.fit.batched``).

Two fleets live here:

* **subtree fleets** -- :func:`train_forest` stacks the subsets a
  partition's subtrees train on (padded to a common capacity, inert
  rows masked) and grows them together with the level-synchronous
  grower (``repro_torch.fit.hist``).  ``train_partitioned_dt(trainer=
  "torch")`` calls it once per partition, so Algorithm 1 becomes P fleet
  runs instead of one Python-loop tree at a time.
* **DSE candidate fleets** -- :func:`fleet_predict` uploads the test
  windows of a *batch* of trained :class:`PartitionedDT` models once and
  walks every model over them on its own tables with the engine's
  partition walk: on the card each hop is one launch of the hop kernel
  (``csrc/engine_hop.cu``), with no host sync until the one fetch of all
  verdicts; on the CPU the plain hop.  So the labels are bit-identical
  to ``PartitionedDT.predict`` and the per-candidate Python evaluation
  loop disappears from ``core.dse.bayes_search``.

:func:`pack_model_fleet` is the JAX package's stacked pack (every model
padded to the batch's largest tables), the layout a walk with a model
axis would read; :func:`fleet_predict` does not use it, since padded
tables cost more to pack and to walk than each model's own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import MAX_BINS, Tree
from repro_torch.device import resolve_device
from repro_torch.fit import hist


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# subtree fleets
# ---------------------------------------------------------------------------
# per-level histogram elements allowed per grower run; fleets whose
# (S, 2**(d-1), m, nbins, C) working set exceeds it run in chunks
_HIST_BUDGET = 16_000_000


def train_forest(
    Xs: list[np.ndarray],
    ys: list[np.ndarray],
    *,
    max_depth: int,
    k_features: int | None = None,
    n_classes: int,
    min_samples_leaf: int = 4,
    min_gain: float = 1e-7,
    max_bins: int = MAX_BINS,
    allowed_features: np.ndarray | None = None,
    device: "str | torch.device | None" = None,
) -> list[Tree]:
    """Train one tree per ``(Xs[i], ys[i])`` subset, the whole fleet grown
    together on ``device`` (``None`` = the card; raises without one).

    Each subset is quantile-binned on its own rows (the shared contract
    binning -- identical edges to what the numpy trainer would compute),
    padded to a common row capacity and bin count, and grown by
    ``hist.grow_forest_arenas`` in chunks of at most ``_HIST_BUDGET``
    histogram elements a level.  Padding never changes a tree.
    Structural parity with ``core.tree.train_tree`` is node-for-node
    (see docs/PARITY.md).
    """
    dev = resolve_device(device)
    S = len(Xs)
    if S == 0:
        return []
    m = int(np.asarray(Xs[0]).shape[1])
    C = int(n_classes)
    allowed_mask = np.zeros(m, dtype=bool)
    if allowed_features is None:
        allowed_mask[:] = True
    else:
        allowed_mask[np.asarray(allowed_features, dtype=np.int64)] = True

    if max_depth < 1:
        return [hist.leaf_tree(y, C) for y in ys]

    edges_list: list[list[np.ndarray]] = []
    binned_list: list[np.ndarray] = []
    for Xf in Xs:
        e, b = hist.bin_for_growth(np.asarray(Xf), max_bins)
        edges_list.append(e)
        binned_list.append(b)

    nbins = max(max((len(e) for e in edges), default=0)
                for edges in edges_list) + 1
    nbins = _round_up(nbins, 8)           # the JAX package's padding
    n_cap = _next_pow2(max(b.shape[0] for b in binned_list))

    kk = int(k_features) if k_features is not None else m + 1
    # chunk the fleet if one level's histogram would blow the memory
    # budget (S * 2**(d-1) * m * nbins * C int32 live at once)
    per_tree = (1 << (max_depth - 1)) * m * nbins * C
    s_chunk = max(1, min(S, _HIST_BUDGET // max(per_tree, 1)))
    s_chunk = _next_pow2(s_chunk + 1) // 2 if s_chunk > 1 else 1  # floor pow2

    trees: list[Tree] = []
    for lo in range(0, S, s_chunk):
        hi = min(lo + s_chunk, S)
        # one padded (s_chunk, n_cap) block a chunk, as the JAX package
        # pads the last chunk to the fleet's one shape
        binned = np.zeros((s_chunk, n_cap, m), dtype=np.int32)
        yb = np.zeros((s_chunk, n_cap), dtype=np.int32)
        valid = np.zeros((s_chunk, n_cap), dtype=bool)
        for i in range(lo, hi):
            ni = binned_list[i].shape[0]
            binned[i - lo, :ni] = binned_list[i]
            yb[i - lo, :ni] = np.asarray(ys[i], dtype=np.int32)
            valid[i - lo, :ni] = True
        feats, bins, counts, last_counts, _ = hist.grow_forest_arenas(
            torch.from_numpy(binned).to(dev), torch.from_numpy(yb).to(dev),
            torch.from_numpy(valid).to(dev), allowed_mask,
            depth=int(max_depth), n_classes=C, nbins=int(nbins),
            k_features=kk, min_samples_leaf=int(min_samples_leaf),
            min_gain=float(min_gain))
        for i in range(hi - lo):
            trees.append(hist.arena_to_tree(
                feats[i], bins[i], counts[i], last_counts[i],
                edges_list[lo + i], C))
    return trees


def train_tree_torch(X, y, *, max_depth, k_features=None,
                     allowed_features=None, n_classes=None,
                     min_samples_leaf=4, min_gain=1e-7,
                     max_bins=MAX_BINS, device=None) -> Tree:
    """Single-tree convenience wrapper: ``core.tree.train_tree``'s device
    twin (same signature plus ``device``, structurally identical
    output)."""
    y = np.asarray(y, dtype=np.int64)
    C = int(n_classes if n_classes is not None else y.max() + 1)
    return train_forest([np.asarray(X)], [y], max_depth=max_depth,
                        k_features=k_features, n_classes=C,
                        min_samples_leaf=min_samples_leaf,
                        min_gain=min_gain, max_bins=max_bins,
                        allowed_features=allowed_features, device=device)[0]


# ---------------------------------------------------------------------------
# DSE candidate fleets
# ---------------------------------------------------------------------------
def pack_model_fleet(pdts: list, *, device: "str | torch.device | None" = None
                     ) -> tuple:
    """Pack a batch of models into ONE stacked ``DeviceTables``.

    Pads every model to the batch's max subtree count ``S``, slot count
    ``k``, threshold count ``T`` and leaf count ``L``, and re-encodes
    exit actions (``action >= S_model`` means exit) for the shared
    ``S``: labels survive as ``action - S`` regardless of which model
    emitted them.  Padded subtrees are never reached (SIDs stay
    model-local), padded threshold slots are ``+inf`` (mark 0, wildcard
    leaf intervals) and padded leaves ``valid=0``, so a walk over a
    model's view gives its own verdicts.  The pack is numpy; the stacked
    arrays are uploaded to ``device`` (``None`` = the card) in one copy
    each.  Returns ``(DeviceTables with leading model axis, n_subtrees)``.
    """
    from repro_torch.core.range_tables import pack_range_exec
    from repro_torch.core.tables import pack_tables
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    packs = [(pack_tables(p), pack_range_exec(p)) for p in pdts]
    S = max(t.n_subtrees for t, _ in packs)
    k = max(t.k for t, _ in packs)
    T = max(r.max_thresholds for _, r in packs)
    L = max(r.max_leaves for _, r in packs)

    def pad_model(t, r):
        s0, k0 = t.slot_op.shape
        l0, t0 = r.leaf_action.shape[1], r.thresholds.shape[2]
        slot_op = np.zeros((S, k), np.int32)
        slot_field = np.zeros((S, k), np.int32)
        slot_pred = np.zeros((S, k), np.int32)
        slot_init = np.zeros((S, k), np.float32)
        thresholds = np.full((S, k, T), np.inf, np.float32)
        leaf_lo = np.zeros((S, L, k), np.int32)
        leaf_hi = np.full((S, L, k), T, np.int32)
        leaf_action = np.full((S, L), -1, np.int32)
        leaf_valid = np.zeros((S, L), np.int32)
        slot_op[:s0, :k0] = t.slot_op
        slot_field[:s0, :k0] = t.slot_field
        slot_pred[:s0, :k0] = t.slot_pred
        slot_init[:s0, :k0] = t.slot_init
        thresholds[:s0, :k0, :t0] = r.thresholds
        leaf_lo[:s0, :l0, :k0] = r.leaf_lo
        leaf_hi[:s0, :l0, :k0] = r.leaf_hi
        # exits were encoded against the model's own subtree count
        act = r.leaf_action.astype(np.int64)
        act = np.where((act >= r.n_subtrees) & (act >= 0),
                       act - r.n_subtrees + S, act)
        leaf_action[:s0, :l0] = act.astype(np.int32)
        leaf_valid[:s0, :l0] = r.leaf_valid.astype(np.int32)
        return (slot_op, slot_field, slot_pred, slot_init, thresholds,
                leaf_lo, leaf_hi, leaf_action, leaf_valid)

    stacked = [np.stack(arrs) for arrs in
               zip(*(pad_model(t, r) for t, r in packs))]
    tables = ops.DeviceTables(*(torch.from_numpy(a).to(dev)
                                for a in stacked))
    return tables, S


def fleet_predict(pdts: list, win_pkts, *,
                  device: "str | torch.device | None" = None):
    """Score a batch of models against one flow batch, one walk a model.

    ``win_pkts``: (B, P, W, F) from ``flows.windows.window_packets`` (a
    numpy array or a tensor) with ``P >= max(model.n_partitions)``,
    uploaded to ``device`` (``None`` = the card) once.  Each model walks
    its own ``n_partitions`` hops on its own tables (``Engine.from_model``),
    dense and without the trace: on the card one launch of the hop kernel
    a hop, ``sum(model.n_partitions)`` launches and no host sync between
    them; on the CPU the plain hop.  The verdicts are bit-identical to
    the serial engine / ``PartitionedDT.predict``.  All M verdict buffers
    come back in one fetch.  Returns ``(labels (M, B), recircs (M, B),
    exit_partition (M, B))`` int32 numpy arrays.
    """
    from repro_torch.core.inference import Engine, fetch, partition_walk
    from repro_torch.kernels.engine_hop import (
        engine_hop_kernel, engine_hop_plain,
    )

    dev = resolve_device(device)
    x = torch.as_tensor(win_pkts).to(device=dev, dtype=torch.float32)
    B, P = x.shape[:2]
    if any(p.n_partitions > P for p in pdts):
        raise ValueError("fewer windows than a model's partitions")
    hop = engine_hop_kernel if dev.type == "cuda" else engine_hop_plain
    bufs = []
    for p in pdts:
        t = Engine.from_model(p, device=dev).tables
        bufs.append(partition_walk(x, t.dev, n_subtrees=t.n_subtrees,
                                   n_partitions=t.n_partitions,
                                   with_trace=False, hop=hop))
    host = fetch(torch.stack(bufs)).reshape(len(pdts), 3, B)
    return host[:, 0], host[:, 1], host[:, 2]

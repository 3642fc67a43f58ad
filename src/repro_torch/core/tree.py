"""Histogram-based CART decision-tree trainer (pure numpy; a copy of
``repro.core.tree``).

SpliDT's subtree learner: quantile-binned features + per-node class
histograms, Gini-gain splits, and -- the SpliDT-specific part -- a hard
budget of at most ``k`` *distinct* features per tree (paper §2.2
"feature density": every subtree must fit in the k feature-register
slots).  Once the tree has consumed k distinct features, further splits
may only reuse those features.

The tree is stored as flat arrays so it can be packed for the engine
(``core/tables.py``).  The copy must train the very same trees as the
JAX package's numpy trainer from the same features: binning
(:func:`quantile_bins` + :func:`bin_data`), f32 split scores with the
class-axis reduction pinned to a left-to-right chain
(:func:`class_sq_chain`), first-argmin / first-argmax tie-breaks and
level-order growth are unchanged.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

MAX_BINS = 64  # quantile bins per feature


@dataclasses.dataclass
class Tree:
    """Flat-array binary decision tree.

    Node 0 is the root.  For internal nodes ``feature/threshold`` define
    ``x[feature] <= threshold -> left else right``.  Leaves have
    ``feature == -1`` and carry a class distribution.  Nodes are
    numbered in level (BFS) order, left before right, so parents always
    precede children.
    """

    feature: np.ndarray      # (n_nodes,) int32, -1 for leaf
    threshold: np.ndarray    # (n_nodes,) float32
    left: np.ndarray         # (n_nodes,) int32
    right: np.ndarray        # (n_nodes,) int32
    value: np.ndarray        # (n_nodes, n_classes) float32 class counts
    n_classes: int

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int((self.feature < 0).sum())

    @property
    def max_depth(self) -> int:
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        for i in range(self.n_nodes):      # parents precede children
            if self.feature[i] >= 0:
                depth[self.left[i]] = depth[i] + 1
                depth[self.right[i]] = depth[i] + 1
        return int(depth.max(initial=0))

    def used_features(self) -> np.ndarray:
        f = self.feature[self.feature >= 0]
        return np.unique(f)

    def thresholds_per_feature(self) -> dict[int, np.ndarray]:
        out: dict[int, np.ndarray] = {}
        for fid in self.used_features():
            thr = self.threshold[self.feature == fid]
            out[int(fid)] = np.unique(thr.astype(np.float32))
        return out

    def apply(self, X: np.ndarray) -> np.ndarray:
        """Leaf index for each row of ``X`` (n, n_features)."""
        n = X.shape[0]
        node = np.zeros(n, dtype=np.int32)
        active = self.feature[node] >= 0
        while active.any():
            idx = np.nonzero(active)[0]
            nd = node[idx]
            f = self.feature[nd]
            thr = self.threshold[nd]
            go_left = X[idx, f] <= thr
            node[idx] = np.where(go_left, self.left[nd], self.right[nd])
            active = self.feature[node] >= 0
        return node


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------
def quantile_bins(X: np.ndarray, max_bins: int) -> list[np.ndarray]:
    """Per-feature ascending candidate thresholds (bin edges)."""
    edges = []
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    for j in range(X.shape[1]):
        col = X[:, j]
        e = np.unique(np.quantile(col, qs, method="lower").astype(np.float32))
        edges.append(e)
    return edges


def bin_data(X: np.ndarray, edges: list[np.ndarray]) -> np.ndarray:
    """Map raw features to bin ids: ``np.searchsorted(edges, x, 'left')``,
    so ``bin(x) <= e  <=>  x <= edges[e]`` exactly."""
    n, m = X.shape
    B = np.empty((n, m), dtype=np.int16)
    for j in range(m):
        B[:, j] = np.searchsorted(edges[j], X[:, j], side="left")
    return B


# ---------------------------------------------------------------------------
# split scoring
# ---------------------------------------------------------------------------
def class_sq_chain(counts: np.ndarray) -> np.ndarray:
    """Left-to-right f32 chain of squared class counts over the last axis.

    The ONLY reduction in the split score whose order matters: f32
    addition is not associative, so the chain is pinned (the trainer
    analogue of ``kernels.ref.ordered_wsum``).  ``counts`` is integer
    (exact in f32 below 2**24); the result is the ``sum_c counts[c]^2``
    term of the Gini impurity.
    """
    acc = np.zeros(counts.shape[:-1], dtype=np.float32)
    for c in range(counts.shape[-1]):
        x = counts[..., c].astype(np.float32)
        acc = acc + x * x
    return acc


def split_scores(hist: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Weighted-Gini child impurity per split edge for one node×feature.

    ``hist``: (n_bins, n_classes) integer class counts per bin;
    ``total``: (n_classes,) node class counts.  Splitting at edge ``e``
    sends bins ``[0..e]`` left.  Returns (n_bins,) f32 child impurity,
    ``+inf`` where a side would be empty.  Lower is better; the parent
    impurity (:func:`node_impurity`) is a per-node constant, so
    ``gain = parent - child``.
    """
    cum = np.cumsum(hist.astype(np.int64), axis=0)      # (n_bins, C) left
    nl = cum.sum(axis=1)                                # (n_bins,)
    n = int(total.sum())
    nr = n - nl
    sl = class_sq_chain(cum)
    sr = class_sq_chain(total[None, :].astype(np.int64) - cum)
    nl_f = nl.astype(np.float32)
    nr_f = nr.astype(np.float32)
    one = np.float32(1.0)
    child = ((nl_f - sl / np.maximum(nl_f, one))
             + (nr_f - sr / np.maximum(nr_f, one)))
    return np.where((nl > 0) & (nr > 0), child,
                    np.float32(np.inf)).astype(np.float32)


def node_impurity(total: np.ndarray) -> np.float32:
    """f32 Gini "impurity mass" ``n - (sum_c total_c^2) / n`` of a node."""
    n_f = np.float32(int(total.sum()))
    st = class_sq_chain(np.asarray(total, dtype=np.int64))
    return np.float32(n_f - st / np.maximum(n_f, np.float32(1.0)))


def train_tree(
    X: np.ndarray,
    y: np.ndarray,
    *,
    max_depth: int,
    k_features: int | None = None,
    allowed_features: np.ndarray | None = None,
    n_classes: int | None = None,
    min_samples_leaf: int = 4,
    min_gain: float = 1e-7,
    max_bins: int = MAX_BINS,
) -> Tree:
    """Train a CART tree with an optional distinct-feature budget.

    ``k_features``: max distinct features in the whole tree (SpliDT
    subtree register budget), enforced greedily in level order: once k
    distinct features have been used anywhere in the tree, only those
    features remain candidates.  ``allowed_features`` restricts
    candidates up-front (used for the top-k baselines).

    Fully deterministic -- no RNG is consumed anywhere.  Tie-break:
    within a feature the lowest bin index wins, across features the
    lowest feature index wins, on the f32 :func:`split_scores`.
    """
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.int64)
    n, m = X.shape
    C = int(n_classes if n_classes is not None else y.max() + 1)
    allowed_mask = np.zeros(m, dtype=bool)
    if allowed_features is None:
        allowed_mask[:] = True
    else:
        allowed_mask[np.asarray(allowed_features, dtype=np.int64)] = True

    edges = quantile_bins(X, max_bins)
    B = bin_data(X, edges)
    min_gain32 = np.float32(min_gain)

    feature: list[int] = []
    threshold: list[float] = []
    left: list[int] = []
    right: list[int] = []
    value: list[np.ndarray] = []

    def new_node() -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(np.zeros(C, dtype=np.float32))
        return len(feature) - 1

    # global distinct-feature budget, grown greedily in level order
    used_mask = np.zeros(m, dtype=bool)

    # BFS frontier: (rows, depth, parent, is_left).  FIFO order = level
    # order, left before right -- node ids and budget-acquisition order
    # both follow it (contract item 4).
    queue = collections.deque([(np.arange(n), 0, -1, False)])
    while queue:
        rows, depth, parent, is_left = queue.popleft()
        node_id = new_node()
        if parent >= 0:
            if is_left:
                left[parent] = node_id
            else:
                right[parent] = node_id
        yb = y[rows]
        total = np.bincount(yb, minlength=C).astype(np.int64)
        value[node_id] = total.astype(np.float32)
        n_node = rows.shape[0]
        pure = (total > 0).sum() <= 1
        if depth >= max_depth or pure or n_node < 2 * min_samples_leaf:
            continue

        # candidate features under the budget
        budget_open = (k_features is None
                       or int(used_mask.sum()) < k_features)
        cand_mask = allowed_mask if budget_open else (allowed_mask & used_mask)

        parent_imp = node_impurity(total)
        gains = np.full(m, -np.inf, dtype=np.float32)
        best_bin = np.zeros(m, dtype=np.int64)
        best_nl = np.zeros(m, dtype=np.int64)
        for j in np.nonzero(cand_mask)[0]:
            j = int(j)
            nb = len(edges[j]) + 1
            bj = B[rows, j].astype(np.int64)
            hist = np.zeros((nb, C), dtype=np.int64)
            np.add.at(hist, (bj, yb), 1)
            child = split_scores(hist, total)
            e = int(np.argmin(child))               # first min: lowest bin
            gains[j] = parent_imp - child[e]        # -inf when child is inf
            best_bin[j] = e
            best_nl[j] = hist[:e + 1].sum()
        j = int(np.argmax(gains))                   # first max: lowest feature
        gain = gains[j]
        if not (gain > min_gain32):
            continue
        e = int(best_bin[j])
        nl = int(best_nl[j])
        if nl < min_samples_leaf or n_node - nl < min_samples_leaf:
            continue
        thr = float(edges[j][e])
        go_left = X[rows, j] <= thr                 # == (bin <= e), exactly

        feature[node_id] = j
        threshold[node_id] = thr
        used_mask[j] = True
        queue.append((rows[go_left], depth + 1, node_id, True))
        queue.append((rows[~go_left], depth + 1, node_id, False))

    return Tree(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float32),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        value=np.stack(value).astype(np.float32),
        n_classes=C,
    )


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> float:
    """Macro-averaged F1 (paper's headline metric).

    Vectorised -- one ``np.bincount`` over the joint (true, pred) index
    builds the whole confusion matrix; it sits on the DSE hot path (one
    call per candidate evaluation).  Out-of-range predictions (e.g. the
    engine's ``-1`` non-termination sentinel) fall into an overflow bin:
    they are a false negative for their true class and a true positive
    for nothing, exactly as the per-class loop scored them.
    """
    yt = np.asarray(y_true, dtype=np.int64).ravel()
    yp = np.asarray(y_pred, dtype=np.int64).ravel()
    C = int(n_classes)
    t = np.where((yt >= 0) & (yt < C), yt, C)
    p = np.where((yp >= 0) & (yp < C), yp, C)
    cm = np.bincount(t * (C + 1) + p,
                     minlength=(C + 1) ** 2).reshape(C + 1, C + 1)
    tp = np.diag(cm)[:C].astype(np.float64)
    fp = cm[:, :C].sum(axis=0) - np.diag(cm)[:C]
    fn = cm[:C, :].sum(axis=1) - np.diag(cm)[:C]
    seen = (tp + fp + fn) > 0
    if not seen.any():
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    return float(np.mean(f1[seen]))

"""Frozen NumPy copy of SpliDT's subtree trainer (the paper's Algorithm 1)
and the model it makes.

``train_tree`` is the program's host CART trainer (``trainer="numpy"``)
step for step: quantile bins, f32 Gini split scores with the class sum
as a left-to-right chain, first-argmin / first-argmax tie-breaks, level
order growth and a budget of k distinct features a tree.
``train_model`` grows the partitions level by level on the flows that
reach each leaf, as ``train_partitioned_dt`` does.  A :class:`Model` is
plain arrays, saved to and loaded from one ``.npz``.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

EXIT = -1


@dataclasses.dataclass
class Tree:
    feature: np.ndarray      # (n_nodes,) int32, -1 at a leaf
    threshold: np.ndarray    # (n_nodes,) f32: x[feature] <= threshold -> left
    left: np.ndarray         # (n_nodes,) int32
    right: np.ndarray        # (n_nodes,) int32
    value: np.ndarray        # (n_nodes, n_classes) f32 class counts

    def apply(self, X: np.ndarray) -> np.ndarray:
        """Leaf reached by each row of ``X`` (n, n_features)."""
        node = np.zeros(X.shape[0], np.int32)
        active = self.feature[node] >= 0
        while active.any():
            idx = np.nonzero(active)[0]
            nd = node[idx]
            go_left = X[idx, self.feature[nd]] <= self.threshold[nd]
            node[idx] = np.where(go_left, self.left[nd], self.right[nd])
            active = self.feature[node] >= 0
        return node

    def depth(self) -> np.ndarray:
        """Depth of every node (parents precede children)."""
        d = np.zeros(self.feature.shape[0], np.int64)
        for i in range(self.feature.shape[0]):
            if self.feature[i] >= 0:
                d[self.left[i]] = d[self.right[i]] = d[i] + 1
        return d


@dataclasses.dataclass
class SubTree:
    partition: int
    tree: Tree
    next_sid: np.ndarray     # (n_nodes,) int32: leaf -> next SID or EXIT


@dataclasses.dataclass
class Model:
    subtrees: list[SubTree]
    partition_sizes: list[int]
    k: int
    n_classes: int

    @property
    def n_partitions(self) -> int:
        return len(self.partition_sizes)

    def used_features(self) -> np.ndarray:
        """The feature ids any subtree reads."""
        return np.unique(np.concatenate(
            [s.tree.feature[s.tree.feature >= 0] for s in self.subtrees]))

    def save(self, path) -> None:
        cat = lambda f: np.concatenate([f(s) for s in self.subtrees])
        np.savez(path,
                 n_nodes=np.asarray([s.tree.feature.shape[0]
                                     for s in self.subtrees]),
                 partition=np.asarray([s.partition for s in self.subtrees]),
                 feature=cat(lambda s: s.tree.feature),
                 threshold=cat(lambda s: s.tree.threshold),
                 left=cat(lambda s: s.tree.left),
                 right=cat(lambda s: s.tree.right),
                 value=cat(lambda s: s.tree.value),
                 next_sid=cat(lambda s: s.next_sid),
                 meta=np.asarray([self.k, self.n_classes,
                                  *self.partition_sizes]))

    @classmethod
    def load(cls, path) -> "Model":
        z = np.load(path)
        k, n_classes, *sizes = (int(v) for v in z["meta"])
        ends = np.cumsum(z["n_nodes"])
        subtrees = []
        for sid, (lo, hi) in enumerate(zip(ends - z["n_nodes"], ends)):
            tree = Tree(*(z[f][lo:hi] for f in
                          ("feature", "threshold", "left", "right", "value")))
            subtrees.append(SubTree(int(z["partition"][sid]), tree,
                                    z["next_sid"][lo:hi]))
        return cls(subtrees, sizes, k, n_classes)


# ---------------------------------------------------------------------------
# the CART trainer
# ---------------------------------------------------------------------------
def _quantile_bins(X: np.ndarray, max_bins: int) -> list[np.ndarray]:
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    return [np.unique(np.quantile(X[:, j], qs, method="lower")
                      .astype(np.float32)) for j in range(X.shape[1])]


def _bin_data(X: np.ndarray, edges: list[np.ndarray]) -> np.ndarray:
    B = np.empty(X.shape, np.int16)
    for j in range(X.shape[1]):
        B[:, j] = np.searchsorted(edges[j], X[:, j], side="left")
    return B


def _class_sq_chain(counts: np.ndarray) -> np.ndarray:
    acc = np.zeros(counts.shape[:-1], np.float32)
    for c in range(counts.shape[-1]):
        x = counts[..., c].astype(np.float32)
        acc = acc + x * x
    return acc


def _split_scores(hist: np.ndarray, total: np.ndarray) -> np.ndarray:
    cum = np.cumsum(hist.astype(np.int64), axis=0)
    nl = cum.sum(axis=1)
    nr = int(total.sum()) - nl
    sl = _class_sq_chain(cum)
    sr = _class_sq_chain(total[None, :].astype(np.int64) - cum)
    nl_f, nr_f = nl.astype(np.float32), nr.astype(np.float32)
    one = np.float32(1.0)
    child = ((nl_f - sl / np.maximum(nl_f, one))
             + (nr_f - sr / np.maximum(nr_f, one)))
    return np.where((nl > 0) & (nr > 0), child,
                    np.float32(np.inf)).astype(np.float32)


def _node_impurity(total: np.ndarray) -> np.float32:
    n_f = np.float32(int(total.sum()))
    st = _class_sq_chain(np.asarray(total, np.int64))
    return np.float32(n_f - st / np.maximum(n_f, np.float32(1.0)))


def train_tree(X, y, *, max_depth: int, k_features: int, n_classes: int,
               min_samples_leaf: int, max_bins: int,
               min_gain: float = 1e-7) -> Tree:
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    n, m = X.shape
    C = n_classes
    edges = _quantile_bins(X, max_bins)
    B = _bin_data(X, edges)
    min_gain32 = np.float32(min_gain)
    feature, threshold, left, right, value = [], [], [], [], []
    used = np.zeros(m, bool)
    queue = collections.deque([(np.arange(n), 0, -1, False)])
    while queue:
        rows, depth, parent, is_left = queue.popleft()
        node = len(feature)
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        if parent >= 0:
            (left if is_left else right)[parent] = node
        yb = y[rows]
        total = np.bincount(yb, minlength=C).astype(np.int64)
        value.append(total.astype(np.float32))
        n_node = rows.shape[0]
        if (depth >= max_depth or (total > 0).sum() <= 1
                or n_node < 2 * min_samples_leaf):
            continue
        cand = np.ones(m, bool) if used.sum() < k_features else used
        parent_imp = _node_impurity(total)
        gains = np.full(m, -np.inf, np.float32)
        best_bin = np.zeros(m, np.int64)
        best_nl = np.zeros(m, np.int64)
        for j in np.nonzero(cand)[0]:
            j = int(j)
            hist = np.zeros((len(edges[j]) + 1, C), np.int64)
            np.add.at(hist, (B[rows, j].astype(np.int64), yb), 1)
            child = _split_scores(hist, total)
            e = int(np.argmin(child))
            gains[j] = parent_imp - child[e]
            best_bin[j] = e
            best_nl[j] = hist[:e + 1].sum()
        j = int(np.argmax(gains))
        if not (gains[j] > min_gain32):
            continue
        nl = int(best_nl[j])
        if nl < min_samples_leaf or n_node - nl < min_samples_leaf:
            continue
        thr = float(edges[j][int(best_bin[j])])
        go_left = X[rows, j] <= thr
        feature[node] = j
        threshold[node] = thr
        used[j] = True
        queue.append((rows[go_left], depth + 1, node, True))
        queue.append((rows[~go_left], depth + 1, node, False))
    return Tree(np.asarray(feature, np.int32), np.asarray(threshold, np.float32),
                np.asarray(left, np.int32), np.asarray(right, np.int32),
                np.stack(value).astype(np.float32))


def train_model(X_windows: np.ndarray, y: np.ndarray, *,
                partition_sizes: list[int], k: int, n_classes: int,
                min_samples_subtree: int, min_samples_leaf: int,
                max_bins: int) -> Model:
    """Algorithm 1: each partition's subtrees grown on the flows that
    reach their parent leaf, on that partition's window features; a leaf
    exits when it is pure, in the last partition, or holds fewer than
    ``min_samples_subtree`` flows.  SIDs in level order."""
    y = np.asarray(y, np.int64)
    P = len(partition_sizes)
    subtrees: list[SubTree] = []
    frontier = [(np.arange(X_windows.shape[0]), -1, -1)]
    for p in range(P):
        if not frontier:
            break
        nxt_frontier = []
        for rows, parent_sid, parent_leaf in frontier:
            Xs = X_windows[rows, p, :]
            t = train_tree(Xs, y[rows], max_depth=int(partition_sizes[p]),
                           k_features=k, n_classes=n_classes,
                           min_samples_leaf=min_samples_leaf,
                           max_bins=max_bins)
            sid = len(subtrees)
            st = SubTree(p, t, np.full(t.feature.shape[0], -2, np.int32))
            subtrees.append(st)
            if parent_sid >= 0:
                subtrees[parent_sid].next_sid[parent_leaf] = sid
            leaves = t.apply(Xs)
            for leaf in np.nonzero(t.feature < 0)[0]:
                leaf = int(leaf)
                subset = rows[leaves == leaf]
                pure = (t.value[leaf] > 0).sum() <= 1
                if p + 1 >= P or pure or subset.shape[0] < min_samples_subtree:
                    st.next_sid[leaf] = EXIT
                else:
                    nxt_frontier.append((subset, sid, leaf))
        frontier = nxt_frontier
    return Model(subtrees, list(partition_sizes), k, n_classes)

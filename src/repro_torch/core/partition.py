"""Partitioned decision trees + SpliDT's custom training (Algorithm 1);
a copy of ``repro.core.partition`` with the numpy trainer only.

A :class:`PartitionedDT` is a collection of subtrees grouped into
partitions.  Subtree 0 (SID 0) lives in partition 0 and sees window 0's
features; each of its leaves either *exits* with a class label or routes
to a subtree in the next partition, which sees window 1's features, and
so on.  Every subtree uses at most ``k`` distinct features -- the
register budget that the data plane time-shares across partitions via
recirculation.

Training follows the paper's Algorithm 1: per-leaf training on exactly
the samples that reach the leaf, using the *next* window's features --
so subtrees specialise to the traffic distribution they will actually
observe at inference time.  Growth is partition-major (level order):
all of partition p's subtrees train before partition p+1's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import tree as tree_lib
from repro_torch.core.features import REGISTRY
from repro_torch.core.tree import Tree, train_tree

EXIT = -1  # leaf routing value: emit class label


@dataclasses.dataclass
class SubTree:
    sid: int
    partition: int                  # which partition (== window index)
    tree: Tree
    # per-leaf routing: maps leaf node id -> next SID, or EXIT
    leaf_next_sid: dict[int, int]
    # per-leaf class label (used when routing == EXIT)
    leaf_label: dict[int, int]

    @property
    def used_features(self) -> np.ndarray:
        return self.tree.used_features()


@dataclasses.dataclass
class PartitionedDT:
    subtrees: list[SubTree]
    partition_sizes: list[int]      # [i_1 .. i_p]; sum == total depth D
    k: int                          # feature slots per subtree
    n_classes: int
    n_features: int

    # ---- structure queries ---------------------------------------------
    @property
    def n_partitions(self) -> int:
        return len(self.partition_sizes)

    def sids_in_partition(self, p: int) -> list[int]:
        return [s.sid for s in self.subtrees if s.partition == p]

    # ---- reference inference (numpy oracle) ---------------------------
    def predict(self, X_windows: np.ndarray,
                return_trace: bool = False):
        """Windowed partitioned inference.

        ``X_windows``: (n, p, N) per-window features.  Returns predicted
        labels (n,); with ``return_trace`` also returns the number of
        partition transitions ("recirculations") per flow and the
        partition index at which each flow exited.
        """
        n = X_windows.shape[0]
        sid = np.zeros(n, dtype=np.int64)            # all flows start at root
        done = np.zeros(n, dtype=bool)
        # verdict arrays start at the -1 sentinel (docs/PARITY.md §2): a
        # flow that never takes an exit action keeps it, so a corrupt/
        # truncated model can't silently claim class 0 at partition 0
        label = np.full(n, -1, dtype=np.int64)
        recircs = np.zeros(n, dtype=np.int64)
        exit_partition = np.full(n, -1, dtype=np.int64)
        for p in range(self.n_partitions):
            active_sids = self.sids_in_partition(p)
            for s_id in active_sids:
                st = self.subtrees[s_id]
                rows = np.nonzero((~done) & (sid == s_id))[0]
                if rows.size == 0:
                    continue
                leaves = st.tree.apply(X_windows[rows, p, :])
                nxt = np.asarray([st.leaf_next_sid.get(int(l), EXIT) for l in leaves])
                lab = np.asarray([st.leaf_label[int(l)] for l in leaves])
                exiting = nxt == EXIT
                done[rows[exiting]] = True
                label[rows[exiting]] = lab[exiting]
                exit_partition[rows[exiting]] = p
                cont = rows[~exiting]
                sid[cont] = nxt[~exiting]
                recircs[cont] += 1                    # one control packet
        # a flow still active after the last partition never took an exit
        # action (possible only for corrupt/truncated models — training
        # exits every leaf of the final partition) and keeps the -1
        # sentinels it was initialised with, matching the engine backends
        if return_trace:
            return label, recircs, exit_partition
        return label


def train_partitioned_dt(
    X_windows: np.ndarray,
    y: np.ndarray,
    *,
    partition_sizes: list[int],
    k: int,
    n_classes: int | None = None,
    min_samples_subtree: int = 16,
    min_samples_leaf: int = 2,
    max_bins: int = tree_lib.MAX_BINS,
    max_dep_depth: int | None = None,
    trainer: str = "numpy",
) -> PartitionedDT:
    """Paper Algorithm 1: per-leaf subtree training, one partition level
    at a time.

    ``X_windows``: (n, p, N) features per window; ``partition_sizes``:
    depth of each partition's subtrees; ``k``: distinct-feature budget
    per subtree.  ``max_dep_depth`` restricts candidate features to
    those whose dependency chain fits the register budget (the DSE sets
    this at high flow targets, where dependency registers are the
    binding constraint).

    ``trainer`` must be ``"numpy"``, the host CART trainer
    (:func:`repro_torch.core.tree.train_tree`), one subtree at a time.
    The jitted fleet grower of the JAX package (``trainer="jax"``) has
    no counterpart in the port yet (ROADMAP item A.8).

    SIDs are assigned in partition-major level order (partition 0's
    subtree, then partition 1's subtrees in the order their parent
    leaves appear, ...), as in the JAX package.
    """
    n, p_avail, N = X_windows.shape
    p = len(partition_sizes)
    if p > p_avail:
        raise ValueError(f"need {p} windows, dataset has {p_avail}")
    if trainer == "jax":
        raise ValueError("trainer='jax' is not ported yet (ROADMAP item "
                         "A.8, the fit/ grower); use trainer='numpy'")
    if trainer != "numpy":
        raise ValueError(f"unknown trainer {trainer!r}; options: numpy")
    y = np.asarray(y, dtype=np.int64)
    C = int(n_classes if n_classes is not None else y.max() + 1)
    allowed = None
    if max_dep_depth is not None:
        allowed = np.asarray([s.fid for s in REGISTRY
                              if s.dep_depth <= max_dep_depth])

    subtrees: list[SubTree] = []

    # frontier entry: (rows, parent_sid, parent_leaf); partition 0 has a
    # single root subtree with no parent
    frontier: list[tuple[np.ndarray, int, int]] = [(np.arange(n), -1, -1)]
    for partition in range(p):
        if not frontier:
            break
        depth = int(partition_sizes[partition])
        fleet_X = [X_windows[rows, partition, :] for rows, _, _ in frontier]
        fleet_y = [y[rows] for rows, _, _ in frontier]
        trees = [train_tree(Xs, ys, max_depth=depth, k_features=k,
                            n_classes=C, min_samples_leaf=min_samples_leaf,
                            max_bins=max_bins, allowed_features=allowed)
                 for Xs, ys in zip(fleet_X, fleet_y)]

        next_frontier: list[tuple[np.ndarray, int, int]] = []
        last = partition + 1 >= p
        for (rows, parent_sid, parent_leaf), Xs, t in zip(
                frontier, fleet_X, trees):
            sid = len(subtrees)
            st = SubTree(sid=sid, partition=partition, tree=t,
                         leaf_next_sid={}, leaf_label={})
            subtrees.append(st)
            if parent_sid >= 0:
                subtrees[parent_sid].leaf_next_sid[parent_leaf] = sid

            leaves = t.apply(Xs)
            leaf_ids = np.nonzero(t.feature < 0)[0]
            for leaf in leaf_ids:
                leaf = int(leaf)
                st.leaf_label[leaf] = int(t.value[leaf].argmax())
                subset = rows[leaves == leaf]
                counts = t.value[leaf]
                pure = (counts > 0).sum() <= 1
                # early exit: last partition, pure leaf, or too few samples
                if last or pure or subset.shape[0] < min_samples_subtree:
                    st.leaf_next_sid[leaf] = EXIT
                else:
                    # SID filled in when the child trains next level
                    next_frontier.append((subset, sid, leaf))
        frontier = next_frontier

    return PartitionedDT(
        subtrees=subtrees, partition_sizes=list(partition_sizes), k=k,
        n_classes=C, n_features=N,
    )

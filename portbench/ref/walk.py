"""The partitioned walk in plain NumPy: every flow starts at subtree 0
on window 0; a leaf either exits with its class or recirculates the
flow to the next partition's subtree, which reads the next window.

:func:`walk` returns the verdicts the program must give for each flow
(label, recirculations, exit partition; -1 sentinels for a flow that
never exits) and what the walk visited, for the work count: the SID
that read each window (-1 where the flow had exited) and the depth of
the leaf it reached.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .trainer import EXIT, Model


@dataclasses.dataclass
class Walk:
    labels: np.ndarray       # (n,) int32
    recircs: np.ndarray      # (n,) int32
    exit_p: np.ndarray       # (n,) int32
    sid: np.ndarray          # (n, P) int32 subtree read at each window, -1
    leaf_depth: np.ndarray   # (n, P) int32 depth of the leaf reached, 0


def walk(model: Model, X: np.ndarray) -> Walk:
    """``X``: (n, P, N_FEATURES) f32 window features."""
    n, P = X.shape[0], model.n_partitions
    sid = np.zeros(n, np.int64)
    done = np.zeros(n, bool)
    labels = np.full(n, -1, np.int32)
    recircs = np.zeros(n, np.int32)
    exit_p = np.full(n, -1, np.int32)
    seen = np.full((n, P), -1, np.int32)
    depth = np.zeros((n, P), np.int32)
    for p in range(P):
        for s in np.unique(sid[~done]):
            st = model.subtrees[int(s)]
            if st.partition != p:
                continue
            rows = np.nonzero(~done & (sid == s))[0]
            leaves = st.tree.apply(X[rows, p, :])
            seen[rows, p] = s
            depth[rows, p] = st.tree.depth()[leaves]
            nxt = st.next_sid[leaves]
            out = nxt == EXIT
            labels[rows[out]] = st.tree.value[leaves[out]].argmax(axis=1)
            exit_p[rows[out]] = p
            done[rows[out]] = True
            cont = rows[~out]
            sid[cont] = nxt[~out]
            recircs[cont] += 1
    return Walk(labels, recircs, exit_p, seen, depth)

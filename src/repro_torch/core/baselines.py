"""One-shot top-k baselines (NetBeacon- / Leo-style, paper §5.1; a copy
of ``repro.core.baselines``).

Both baselines select a fixed global top-k stateful feature set and run a
single-pass DT over whole-flow statistics:

  * NetBeacon-style ("nb"): deeper trees, importance-ranked top-k,
    range-marking TCAM encoding (their own algorithm).
  * Leo-style ("leo"): depth-constrained trees whose TCAM footprint is a
    power-of-two block grid (Leo allocates fixed rule blocks), modelled
    as entries rounded up to the next power of two.

Fidelity note: NetBeacon's multi-phase inference (exponentially growing
packet counts with *retained* statistics and the same top-k features per
phase) converges to whole-flow features at the final phase; we evaluate
the final phase, which is the baseline's best case.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.rangemark import build_subtree_rules
from repro_torch.core.resources import ResourceReport, Target, TOFINO1, estimate_oneshot
from repro_torch.core.tree import Tree, feature_importance, macro_f1, train_tree


@dataclasses.dataclass
class OneShotModel:
    tree: Tree
    feature_ids: np.ndarray     # the global top-k set
    k: int
    depth: int
    style: str                  # "nb" | "leo"
    tcam_entries: int
    key_bits: int

    def predict(self, X_full: np.ndarray) -> np.ndarray:
        return self.tree.predict(X_full)

    def f1(self, X_full: np.ndarray, y: np.ndarray, n_classes: int) -> float:
        return macro_f1(y, self.predict(X_full), n_classes)

    def resources(self, *, target: Target = TOFINO1, bits: int = 32,
                  flows: int | None = None) -> ResourceReport:
        n_used = len(self.tree.used_features())
        from repro_torch.core.features import max_dep_depth
        dep = max_dep_depth(self.tree.used_features())
        return estimate_oneshot(
            max(n_used, 1), self.tcam_entries, self.key_bits,
            target=target, bits=bits, flows=flows,
            dep_depth=dep, depth=self.tree.max_depth)


def train_oneshot_topk(
    X_full: np.ndarray,
    y: np.ndarray,
    *,
    k: int,
    depth: int,
    style: str = "nb",
    n_classes: int | None = None,
    bits: int = 32,
    importances: np.ndarray | None = None,
) -> OneShotModel:
    """Train a top-k one-shot baseline on whole-flow features."""
    C = int(n_classes if n_classes is not None else y.max() + 1)
    if importances is None:
        importances = feature_importance(X_full, y, n_classes=C)
    topk = np.argsort(importances)[::-1][:k]
    t = train_tree(X_full, y, max_depth=depth, allowed_features=topk,
                   n_classes=C)
    leaf_action = {int(i): int(t.value[i].argmax())
                   for i in np.nonzero(t.feature < 0)[0]}
    rules = build_subtree_rules(t, leaf_action, bits=bits, sid_bits=0)
    entries = rules.total_entries
    if style == "leo":
        entries = int(2 ** np.ceil(np.log2(max(entries, 1))))
    return OneShotModel(
        tree=t, feature_ids=np.asarray(topk), k=k, depth=depth, style=style,
        tcam_entries=entries, key_bits=rules.key_bits,
    )


def best_oneshot_for_flows(
    X_tr: np.ndarray, y_tr: np.ndarray, X_te: np.ndarray, y_te: np.ndarray,
    *,
    flows: int,
    style: str,
    n_classes: int,
    target: Target = TOFINO1,
    bits: int = 32,
    k_grid=(1, 2, 3, 4, 6),
    depth_grid=(3, 5, 8, 10, 13),
) -> tuple[OneShotModel | None, float]:
    """Grid-search the baseline family for the best feasible model at a
    flow target (paper: 'the best-performing model each baseline can
    support using all available hardware resources')."""
    imp = feature_importance(X_tr, y_tr, n_classes=n_classes)
    best, best_f1 = None, -1.0
    for k in k_grid:
        for d in depth_grid:
            m = train_oneshot_topk(X_tr, y_tr, k=k, depth=d, style=style,
                                   n_classes=n_classes, bits=bits,
                                   importances=imp)
            rep = m.resources(target=target, bits=bits, flows=flows)
            if not rep.feasible:
                continue
            f1 = m.f1(X_te, y_te, n_classes)
            if f1 > best_f1:
                best, best_f1 = m, f1
    return best, best_f1
